"""The published-weights recipe of the port on the CPU, against the JAX
package: a DeepMind `CheckPoint` npz in the published layout (built from a
TINY JAX model by chip_smoke.py's `published_checkpoint`, in both Haiku
dialects: nested, and flat 'a/b/c' module paths) goes through
`gencast_tpu_torch.tools.translate_checkpoint` into a port model whose
parameters are the JAX model's bit for bit, and `evaluate` serves it.

The helper itself is pinned first: the JAX package's own
`deepmind_checkpoint.denoiser_state` + `translate.merge_into` on its file
give back the JAX model's state bitwise. Then the port's translation: its
`translate.gencast_denoiser` equals the JAX one on the same tree, the
tool's checkpoint restores the JAX parameters bitwise, the denoiser
outputs agree within DENOISER_RTOL at float32, the mesh embedder's dummy
rows are dropped, an unknown key and a shape mismatch raise, an orbax-style
directory is refused by name, and the reference typed-npz form translates
too.
"""

import json
import os

import flax.nnx as nnx
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gencast_tpu import configs as jax_configs
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.training import deepmind_checkpoint as jax_dm
from gencast_tpu.training import translate as jax_translate
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.data import layout
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.tools import translate_checkpoint as tool
from gencast_tpu_torch.training import checkpoint
from gencast_tpu_torch.training import deepmind_checkpoint as dm
from gencast_tpu_torch.training import evaluate, npz_checkpoint, translate
from tests.test_torch_tiny_reference import _tiny_pair
from tests.test_torch_training import _flat
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# One float32 TINY denoiser call, port against JAX on the same translated
# weights, max|port - jax| / max|jax| (7e-7 seen: the einsum tri-block in
# another summation order).
DENOISER_RTOL = 1e-5
DIALECTS = ('nested', 'flat')
# The translation tool's flags: TINY on the CPU, a seeded model other than
# the JAX one's (every parameter is overwritten).
TOOL_FLAGS = ['--preset', 'tiny', '--device', 'cpu', '--seed', '9']


@pytest.fixture(scope='module')
def tiny():
  """The JAX TINY model (perturbed weights), its parameters flat, and the
  data of one denoiser call."""
  jmodel, _, data = _tiny_pair('triblock')
  return jmodel, _flat(nnx.state(jmodel, nnx.Param)), data


def _configs():
  model, _ = configs.build_gencast(configs.TINY, device='cpu')
  return tool.preset_configs(model, configs.TINY)


@pytest.fixture(scope='module')
def published(tiny, tmp_path_factory):
  """{dialect: (CheckPoint tree, its npz path)}."""
  root = tmp_path_factory.mktemp('published')
  out = {}
  for dialect in DIALECTS:
    tree = chip_smoke.published_checkpoint(tiny[1], _configs(), dialect,
                                           seed=3)
    path = str(root / f'{dialect}.npz')
    dm.save(path, tree)
    out[dialect] = (tree, path)
  return out


def _jax_merged(translated) -> dict:
  """A freshly seeded JAX TINY model's parameters with `translated`
  merged in by the JAX package's merge_into, flat."""
  spec = jax_configs.TINY
  lat, lon = jax_configs.grid_for_resolution(spec.resolution_deg)
  statics = jax_compiler.build_graph_statics(
      spec.mesh_splits, lat, lon, attention_k_hop=spec.attention_k_hop,
      build_triblock_mask=True, cache_dir=None)
  fresh, _ = jax_configs.build_gencast(spec, rngs=nnx.Rngs(1),
                                       statics=statics)
  target = nnx.to_pure_dict(nnx.state(fresh, nnx.Param))
  jax_translate.merge_into(target, {'denoiser': translated})
  return _flat_pure(target)


def _flat_pure(tree) -> dict:
  """A nested state as flat numpy arrays keyed 'a/b/c'."""
  return {k: np.asarray(v) for k, v in tool.flatten(tree).items()}


def _assert_bitwise(got: dict, want: dict):
  assert sorted(got) == sorted(want)
  for k, w in want.items():
    assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
    assert np.array_equal(got[k].view(np.uint32), w.view(np.uint32)), k


def _translated_port_model(ckpt_dir, seed=5):
  """A port TINY model of another seed restored from the tool's
  checkpoint, as evaluate restores it (the wrapper stack of TOOL_FLAGS)."""
  model, _ = configs.build_gencast(configs.TINY, seed=seed, device='cpu')
  task = model.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  stack = wrappers.build_stack(model, stats, bf16=configs.TINY.cast_bf16)
  assert checkpoint.restore(checkpoint.create_manager(ckpt_dir), stack) == 0
  return model


@pytest.mark.parametrize('dialect', DIALECTS)
def test_helper_pinned_by_the_jax_translation(tiny, published, dialect):
  """The JAX package's own reading of the helper's file gives back the JAX
  model's parameters bitwise (so the helper writes the published layout
  the JAX translation expects), and the file holds Haiku's leaf names."""
  tree, path = published[dialect]
  keys = np.load(path).files
  assert all(k.rsplit(':', 1)[-1] in ('w', 'b') for k in keys
             if k.startswith('params:'))
  if dialect == 'flat':
    assert all(k.startswith('params:denoiser/~/') for k in keys
               if k.startswith('params:'))
  translated = jax_dm.denoiser_state(jax_dm.load(path))
  _assert_bitwise(_jax_merged(translated), tiny[1])


@pytest.mark.parametrize('dialect', DIALECTS)
def test_port_translate_equals_jax(published, dialect):
  """The port's deepmind_checkpoint + translate give the JAX package's
  nested state on the same file, leaf for leaf and bit for bit."""
  _, path = published[dialect]
  ours = dm.denoiser_state(dm.load(path))
  theirs = jax_dm.denoiser_state(jax_dm.load(path))
  _assert_bitwise(_flat_pure(ours), _flat_pure(theirs))
  assert (dm.config_tree(dm.load(path), 'sampler_config')
          == jax_dm.config_tree(jax_dm.load(path), 'sampler_config'))


def test_int_and_str_keys_translate_alike(published):
  """A tree whose list-like nodes are int-keyed (as a tree built in
  memory may be) translates as its str-keyed form from the npz."""
  tree = dm.find_denoiser(dm.normalize_params(
      dm.load(published['nested'][1])['params']))

  def int_keys(node):
    if not isinstance(node, dict):
      return node
    return {int(k) if k.isdigit() else k: int_keys(v)
            for k, v in node.items()}

  _assert_bitwise(_flat_pure(translate.gencast_denoiser(int_keys(tree))),
                  _flat_pure(translate.gencast_denoiser(tree)))


@pytest.mark.parametrize('dialect', DIALECTS)
def test_tool_restores_the_jax_parameters_and_outputs(tiny, published,
                                                      dialect, tmp_path):
  """translate_checkpoint on the CPU: step_0.pt restores into a port model
  of another seed with the JAX model's parameters bitwise, and one
  float32 denoiser call agrees with the JAX model's."""
  jmodel, jflat, (inputs, targets, forcings) = tiny
  ckpt_dir = str(tmp_path / 'ckpt')
  path = tool.main(['--ref', published[dialect][1], '--out', ckpt_dir]
                   + TOOL_FLAGS)
  assert path == os.path.join(ckpt_dir, 'step_0.pt')
  model = _translated_port_model(ckpt_dir)
  _assert_bitwise(bridge.export_reference_params(model), jflat)
  sigma = np.asarray([1.9], np.float32)
  want = np.asarray(jmodel(*map(jnp.asarray,
                                (inputs, targets, sigma, forcings))))
  with torch.no_grad():
    got = model(*map(torch.as_tensor,
                     (inputs, targets, sigma, forcings))).numpy()
  rel = float(np.abs(got - want).max() / np.abs(want).max())
  assert rel <= DENOISER_RTOL, rel


def test_dummy_rows_dropped(tiny, published):
  """The published mesh-node embedder holds one input row per grid data
  channel after the 3 structural features; the translation keeps the 3."""
  tree, _ = published['nested']
  key = ('embedder_network', 'embed_node_fns', 'mesh_nodes', 'network',
         'network', 'layers', '0', 'w')
  node = tree['params']['denoiser']['predictor']['grid2mesh_gnn']
  for k in key:
    node = node[k]
  prefix = 'denoiser/architecture/grid2mesh/node_embedders/'
  mesh = tiny[1][prefix + 'mesh/network/layers/0/kernel']
  grid = tiny[1][prefix + 'grid/network/layers/0/kernel']
  assert node.shape == (grid.shape[0], mesh.shape[1]) and mesh.shape[0] == 3
  assert np.abs(node[3:]).min() > 0  # nonzero rows, or dropping shows nothing
  den = dm.denoiser_state(dm.load(published['nested'][1]))
  kept = den['architecture']['grid2mesh']['node_embedders']['mesh'][
      'network']['layers']['0']['kernel']
  np.testing.assert_array_equal(kept, node[:3])


def _rewritten(published, tmp_path, edit) -> str:
  tree = dm.load(published['nested'][1])
  edit(tree['params']['denoiser']['predictor'])
  path = str(tmp_path / 'edited.npz')
  dm.save(path, tree)
  return path


def test_unknown_key_raises(published, tmp_path):
  """A module the model lacks (a second grid2mesh message-passing step)."""
  def add_step(predictor):
    procs = predictor['grid2mesh_gnn']['processor_networks']
    procs['1'] = procs['0']

  path = _rewritten(published, tmp_path, add_step)
  with pytest.raises(KeyError, match='translated key not in target'):
    tool.main(['--ref', path, '--out', str(tmp_path / 'ckpt')] + TOOL_FLAGS)


def test_shape_mismatch_raises(published, tmp_path):
  def narrow(predictor):
    lin = predictor['mesh2grid_gnn']['decoder_network']['embed_node_fns'][
        'grid_nodes']['network']['network']['layers']['2']
    lin['w'], lin['b'] = lin['w'][:, 1:], lin['b'][1:]

  path = _rewritten(published, tmp_path, narrow)
  with pytest.raises(ValueError, match='shape mismatch'):
    tool.main(['--ref', path, '--out', str(tmp_path / 'ckpt')] + TOOL_FLAGS)


def test_orbax_directory_refused(tmp_path):
  ref = tmp_path / 'orbax_ckpt'
  (ref / 'default').mkdir(parents=True)
  (ref / '_CHECKPOINT_METADATA').write_text('{}')
  with pytest.raises(SystemExit, match='orbax.*imports jax'):
    tool.main(['--ref', str(ref), '--out', str(tmp_path / 'ckpt')]
              + TOOL_FLAGS)
  assert not (tmp_path / 'ckpt').exists()


def test_typed_npz_tree_translates(tiny, published, tmp_path):
  """The reference's typed-npz form (NNX leaf names, the denoiser under
  wrapper nesting, no `params` entry) gives the same parameters."""
  nnx_tree = dm.normalize_params(
      dm.load(published['nested'][1])['params'])['denoiser']
  path = str(tmp_path / 'typed.npz')
  npz_checkpoint.dump(path, {'predictor': {'denoiser': nnx_tree}})
  assert not dm.is_checkpoint_npz(path)
  tool.main(['--ref', path, '--out', str(tmp_path / 'ckpt')] + TOOL_FLAGS)
  _assert_bitwise(bridge.export_reference_params(
      _translated_port_model(str(tmp_path / 'ckpt'))), tiny[1])


def test_published_weights_recipe_on_cpu(published, tmp_path, capsys):
  """translate_checkpoint --device cpu, then evaluate with the NetCDF
  statistics the port's synth_era5 writes in DeepMind's layout: step 0
  restored, 1 member x 1 step, finite scores."""
  pytest.importorskip('h5py')
  from gencast_tpu_torch.tools import synth_era5
  stats_dir = str(tmp_path / 'stats')
  synth_era5.synthesize_stats(stats_dir, seed=7)
  ckpt_dir, out = str(tmp_path / 'ckpt'), str(tmp_path / 'eval')
  tool.main(['--ref', published['flat'][1], '--out', ckpt_dir] + TOOL_FLAGS)
  evaluate.main(['--preset', 'tiny', '--device', 'cpu', '--ckpt_dir',
                 ckpt_dir, '--stats_path', stats_dir, '--num_members', '1',
                 '--max_rollout_steps', '1', '--plot_vars', '--out_dir',
                 out])
  assert 'restored checkpoint step 0' in capsys.readouterr().out
  with open(os.path.join(out, 'metrics.json')) as f:
    rmse = json.load(f)['rmse']
  assert rmse and all(np.isfinite(v) for v in rmse.values())
