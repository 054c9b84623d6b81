"""The model axis (--mp, `gencast_tpu_torch.parallel.tensor`) on the CPU.

- Over 2 spawned gloo ranks (tests/torch_ranks.py `model_axis_rank`, each
  with its own timeout), bridged JAX weights: the TINY_PALLAS,
  TINY_TRIBLOCK and TINY (einsum tri-block) denoisers' forward, and for
  those and TINY GraphCast the training step (loss, every gradient, the
  clip's global norm and the parameters after one AdamW step whose clip
  binds) against the JAX package on a real `meshes.make_mesh(1, 1, 2)`
  with `shard_model`, and against the port at --mp 1; the bf16 stack at
  --mp 2 against --mp 1; the draws of the ranks of one model group; the
  clip on a replicated and a sharded gradient; a checkpoint written under
  --mp 2 restored under --mp 1; the all_reduce calls of a TINY_PALLAS step
  under each remat policy, as derived.
- The CLIs as processes: `--dp 2 --mp 2` (4 ranks) against one process,
  a checkpoint of `--mp 2` resumed under --mp 2 and under --mp 1, the pod
  forecast on 4 ranks (ensemble 2 x model 2) against the one-device
  members, and `dryrun_multichip(4)` against `dryrun_multichip(1)`.
"""

import json
import os
import shutil

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.data import registry as jax_registry
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.models import diffusion_utils as jax_diffusion
from gencast_tpu.models import gencast as jax_gencast
from gencast_tpu.models import graphcast as jax_gc
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu.models.denoiser import DenoiserConfig as JaxDenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig as JaxTransformer
from gencast_tpu.parallel import meshes as jax_meshes
from gencast_tpu.training import steps as jax_steps
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.ops import metrics
from gencast_tpu_torch.parallel import ensemble, tensor
from gencast_tpu_torch.scripts import ensemble_forecast_pod as pod
from gencast_tpu_torch.tools import dryrun_multichip as dryrun
from gencast_tpu_torch.training import checkpoint, steps, train
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# --mp 2 against --mp 1 of the port, float32: max|a - b| <= RTOL * max|b|
# per array (loss, forward, each gradient, each parameter after the step,
# the clip norm); only the order of the float32 sums differs.
MP_RTOL = 1e-5
# The port at --mp 2 against the JAX package on a (1, 1, 2) mesh, float32:
# the loss, forward and clip norm within LOSS_RTOL; each gradient within
# GRAD_RTOL of its largest entry (the port's float32 tolerance against JAX
# without a model axis, tests/test_torch_training.py); each parameter's
# change after the step within STEP_RTOL of its largest change (Adam
# divides a gradient by its own RMS: an entry near zero turns summation
# noise into a change of the update's size).
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
STEP_RTOL = 2e-2
# The bf16 stacks at --mp 2 against --mp 1: the loss, and each gradient
# relative to its largest entry (bf16 partials round before their float32
# sum; the bf16 tests' bounds, tests/test_torch_graphcast.py).
BF16_RTOL = 5e-2
BF16_GRAD_RTOL = 0.1
# The clip binds: the global norms here are 10-100, and a clipped gradient
# of norm 1e-7 has entries near AdamW's eps (1e-8), where the clip factor
# moves the update.
OPTIMIZER = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                 clip_norm=1e-7)
# The pod's members (2 steps of 39 denoiser calls, partials summed over 2
# ranks) against the one-device members, max relative; its scores against
# ops.metrics on the saved members.
POD_RTOL = 1e-4
SCORES_RTOL = 1e-5
# dryrun_multichip(4) at (1, 2, 2) against (1): the toy's mean loss over
# the global batch, relative.
DRYRUN_RTOL = 1e-5
TRAIN = 'gencast_tpu_torch.training.train'

GC_TASK = dict(
    input_variables=['2m_temperature', 'temperature',
                     'toa_incident_solar_radiation', 'year_progress_sin',
                     'land_sea_mask'],
    target_variables=['2m_temperature', 'temperature'],
    forcing_variables=['toa_incident_solar_radiation', 'year_progress_sin'],
    pressure_levels=[500, 1000], num_input_frames=2)
GC_LAT = np.arange(-90.0, 90.0 + 1e-6, 30.0, dtype=np.float32)
GC_LON = np.arange(0.0, 360.0, 30.0, dtype=np.float32)

CASES = {
    'pallas': dict(model='gencast', preset='tiny_pallas', tile=32,
                   bf16=True, checkpoint=True),
    'triblock_pallas': dict(model='gencast', preset='tiny_triblock', tile=32),
    'triblock': dict(model='gencast', preset='tiny', tile=32),
    'graphcast': dict(model='graphcast', splits=2, latent=32, steps=3,
                      task=GC_TASK, lat=GC_LAT.tolist(),
                      lon=GC_LON.tolist()),
}


def _flat(state):
  return {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in nnx.to_flat_state(state)}


def _jax_model(case):
  """The case's JAX model (perturbed weights), its flat weights, and the
  JAX statics' grid."""
  if case['model'] == 'graphcast':
    statics = jax_compiler.build_graph_statics(
        case['splits'], GC_LAT, GC_LON, build_attention_mask=False,
        build_multimesh=True)
    model = jax_gc.GraphCast(
        jax_registry.TaskSpec(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in GC_TASK.items()}),
        statics, jax_gc.GraphCastConfig(latent_size=case['latent'],
                                        gnn_msg_steps=case['steps']),
        rngs=nnx.Rngs(0))
    lat, lon = GC_LAT, GC_LON
  else:
    spec = configs.SPECS[case['preset']]
    lat, lon = jax_configs.grid_for_resolution(spec.resolution_deg)
    statics = jax_compiler.build_graph_statics(
        spec.mesh_splits, lat, lon, attention_k_hop=spec.attention_k_hop,
        attention_tile_size=case['tile'], cache_dir=None)
    model = jax_gencast.GenCast(
        spec.task, statics,
        JaxTransformer(d_model=spec.d_model, num_layers=spec.num_layers,
                       num_heads=spec.num_heads, ffw_hidden=spec.ffw_hidden,
                       attention_type=spec.attention_type,
                       use_gradient_checkpointing=True, remat_policy='full'),
        denoiser_config=JaxDenoiserConfig(latent_size=spec.d_model),
        rngs=nnx.Rngs(0))
  state = nnx.to_flat_state(nnx.state(model, nnx.Param))
  flat = bridge.perturbed(_flat(nnx.state(model, nnx.Param)), seed=7)
  nnx.update(model, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in state]))
  return model, flat, np.asarray(lat), np.asarray(lon)


def _jax_side(case, model, data):
  """The JAX stack of `model` on a (1, 1, 2) mesh, shard_model'ed:
  forward, loss, gradients, their global norm, and the parameters after
  one train_step of OPTIMIZER, keyed as model_axis_step's."""
  task = model.task
  stats = jax_layout.Stats.unit(
      set(task.input_variables) | set(task.target_variables),
      task.pressure_levels)
  stack = jax_wrappers.build_stack(model, stats, bf16=False)
  mesh = jax_meshes.make_mesh(1, 1, 2, devices=jax.devices()[:2])
  batch = [jnp.asarray(data[k]) for k in ('inputs', 'targets', 'forcings')]
  key = jax.random.PRNGKey(5)
  out = {}
  with jax.set_mesh(mesh):
    jax_meshes.shard_model(stack, mesh)
    if case['model'] != 'graphcast':
      out['forward'] = np.asarray(stack(
          batch[0], jnp.asarray(data['noisy']), jnp.asarray(data['sigma']),
          batch[2]))

    @nnx.jit
    def loss_and_grads(m, inputs, targets, forcings, key):
      def loss_fn(m_):
        loss, _ = m_.loss(inputs, targets, forcings, key)
        return loss.mean(), loss
      return nnx.value_and_grad(loss_fn, has_aux=True)(m)

    (_, loss), grads = loss_and_grads(stack, *batch, key)
    out['loss'] = np.asarray(loss)
    grads = _flat(grads)
    out.update({f'grad:{k[len("predictor/"):]}': v
                for k, v in grads.items()})
    out['norm'] = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                              for v in grads.values()))
    optimizer = jax_steps.create_optimizer(
        stack, jax_steps.OptimizerConfig(**OPTIMIZER))
    jax_meshes.shard_model(optimizer, mesh)
    jax_steps.train_step(stack, optimizer, *batch, key)
  out.update({f'param:{k}': v
              for k, v in _flat(nnx.state(model, nnx.Param)).items()})
  return out


def _data(case, jmodel, lat, lon):
  """Seeded inputs, targets, forcings and noisy targets of batch 1, and the
  noise level and noise JAX's loss draws from PRNGKey(5)."""
  rng = np.random.default_rng(0)
  grid = (1, lat.size, lon.size)
  layouts = (jmodel if case['model'] == 'graphcast' else jmodel.denoiser)
  data = {
      'inputs': rng.standard_normal(
          grid + (layouts.input_layout.num_channels,)),
      'targets': rng.standard_normal(
          grid + (layouts.target_layout.num_channels,)),
      'forcings': rng.standard_normal(
          grid + (layouts.forcing_layout.num_channels,)),
      'noisy': 3.0 * rng.standard_normal(
          grid + (layouts.target_layout.num_channels,))}
  data = {k: v.astype(np.float32) for k, v in data.items()}
  if case['model'] != 'graphcast':
    nc = jmodel.noise_config
    k_sigma, k_noise = jax.random.split(jax.random.PRNGKey(5))
    data['sigma'] = np.asarray(jax_diffusion.rho_inverse_cdf(
        nc.training_min_noise_level, nc.training_max_noise_level,
        nc.training_noise_level_rho,
        jax.random.uniform(k_sigma, (1,), dtype=jnp.float32)))
    data['noise'] = np.asarray(jmodel._sphere_noise(k_noise, 1,
                                                    jnp.float32))
  return data


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """For each case: the JAX side, the port at --mp 1 here and the 2 ranks'
  files."""
  work = str(tmp_path_factory.mktemp('model_axis'))
  cases, jax_out, one = {}, {}, {}
  for name, case in CASES.items():
    case = dict(case, optimizer=OPTIMIZER)
    jmodel, flat, lat, lon = _jax_model(case)
    case.setdefault('lat', lat.tolist())
    case.setdefault('lon', lon.tolist())
    cases[name] = case
    data = _data(case, jmodel, lat, lon)
    np.savez(os.path.join(work, f'{name}.npz'), **data,
             **{f'param:{k}': v for k, v in flat.items()})
    jax_out[name] = _jax_side(case, jmodel, data)
    for bf16 in (False, True) if case.get('bf16') else (False,):
      model, stack = torch_ranks.model_axis_stack(case, flat, bf16)
      tag = f'{name}_bf16' if bf16 else name
      one.update(torch_ranks.model_axis_step(tag, case, model, stack, data,
                                             None, with_step=not bf16))
  with open(os.path.join(work, 'cases.json'), 'w') as f:
    json.dump(cases, f)
  torch_ranks.run_ranks(torch_ranks.model_axis_rank, 2, (work,))
  ranks = [dict(np.load(os.path.join(work, f'rank{r}.npz')))
           for r in range(2)]
  return dict(work=work, cases=cases, jax=jax_out, one=one, ranks=ranks)


def _rel(got, want) -> float:
  scale = float(np.abs(want).max())
  return float(np.abs(np.asarray(got) - want).max()) / max(scale, 1e-30)


@pytest.mark.parametrize('name', sorted(CASES))
def test_mp2_matches_mp1(runs, name):
  """At --mp 2 the port computes the unsharded model: every number of the
  step (gathered) within MP_RTOL of --mp 1's, on both ranks alike."""
  one, got = runs['one'], runs['ranks'][0]
  keys = [k for k in one if k.startswith(f'{name}:')]
  assert len(keys) > 10 and all(k in got for k in keys)
  for k in keys:
    assert _rel(got[k], one[k]) <= MP_RTOL, k


@pytest.mark.parametrize('name', sorted(CASES))
def test_mp2_matches_jax_on_a_model_mesh(runs, name):
  """The port at --mp 2 against the JAX package on a (1, 1, 2) mesh: the
  forward, the loss, every gradient, the clip's global norm (the unsharded
  model's: no replicated gradient counted twice) and each parameter's
  change after one AdamW step with a binding clip."""
  want, got = runs['jax'][name], runs['ranks'][0]
  start = {k[len('param:'):]: v for k, v in np.load(os.path.join(
      runs['work'], f'{name}.npz')).items() if k.startswith('param:')}
  for k in ('loss', 'norm') + (('forward',) if 'forward' in want else ()):
    assert _rel(got[f'{name}:{k}'], want[k]) <= LOSS_RTOL, k
  assert float(want['norm']) > 10 * OPTIMIZER['clip_norm']  # it binds
  grads = [k for k in want if k.startswith('grad:')]
  assert len(grads) == len(start)
  for k in grads:
    assert (np.abs(got[f'{name}:{k}'] - want[k]).max()
            <= GRAD_RTOL * max(float(np.abs(want[k]).max()), 1e-30)), k
  for k, p0 in start.items():
    moved = want[f'param:{k}'] - p0
    assert (np.abs(got[f'{name}:param:{k}'] - p0 - moved).max()
            <= STEP_RTOL * float(np.abs(moved).max())), k


def test_bf16_stack_at_mp2_matches_mp1(runs):
  one, got = runs['one'], runs['ranks'][0]
  assert _rel(got['pallas_bf16:loss'], one['pallas_bf16:loss']) <= BF16_RTOL
  grads = [k for k in one if k.startswith('pallas_bf16:grad:')]
  assert grads
  for k in grads:
    assert (np.abs(got[k] - one[k]).max()
            <= BF16_GRAD_RTOL * max(float(np.abs(one[k]).max()), 1e-30)), k


def test_ranks_of_a_model_group_draw_alike(runs):
  a, b = runs['ranks']
  for k in ('draw_sigma', 'draw_noise'):
    assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


def test_clip_counts_a_replicated_gradient_once(runs):
  """clip_by_global_norm_ over the model axis: the replicated gradient
  [3, 4] (the same on both ranks) once, the sharded [1, 2, 3, 4] summed
  over the ranks: sqrt(25 + 30); counting the replicated one on each rank
  would give sqrt(80)."""
  want = np.sqrt(25.0 + 30.0)
  for got in runs['ranks']:
    assert abs(float(got['clip_norm']) - want) <= 1e-6 * want
    assert abs(float(got['clip_norm']) - np.sqrt(80.0)) > 1.0
    np.testing.assert_allclose(got['clip_replicated'], [3 / want, 4 / want],
                               rtol=1e-6)
    np.testing.assert_allclose(got['clip_sharded'],
                               np.arange(1.0, 5.0) / want, rtol=1e-6)


def test_checkpoint_from_mp2_restores_under_mp1(runs):
  """The file written under --mp 2 holds full tensors: restored under
  --mp 1, the parameters and AdamW's moments are bitwise the ranks' slices
  put together."""
  case = runs['cases']['pallas']
  flat = {k[len('param:'):]: v for k, v in np.load(os.path.join(
      runs['work'], 'pallas.npz')).items() if k.startswith('param:')}
  _, stack = torch_ranks.model_axis_stack(case, flat)
  optimizer = steps.create_optimizer(stack, steps.OptimizerConfig(
      **OPTIMIZER))
  manager = checkpoint.create_manager(os.path.join(runs['work'], 'ckpt'))
  assert checkpoint.restore(manager, stack, optimizer) == 0
  # Where each sharded tensor is cut: the dims of a model sharded in two.
  _, twin = torch_ranks.model_axis_stack(case, flat)
  tensor.shard_model(twin, tensor.ModelAxis(None, 2, 0))
  dims = tensor.sharded_dims(twin)
  assert dims
  ranks = runs['ranks']

  def whole(key, dim):
    parts = [r[key] for r in ranks]
    return parts[0] if dim is None else np.concatenate(parts, axis=dim)

  for i, (name, p) in enumerate(stack.named_parameters()):
    want = whole(f'local:{name}', dims.get(name))
    assert np.array_equal(p.detach().numpy().view(np.uint32),
                          want.view(np.uint32)), name
    for k in ('exp_avg', 'exp_avg_sq'):
      got = optimizer.adamw.state[p][k].numpy()
      assert np.array_equal(got.view(np.uint32), whole(
          f'moment:{i}:{k}', dims.get(name)).view(np.uint32)), (name, k)


@pytest.fixture(scope='module')
def calls(tmp_path_factory):
  """The model axis's all_reduce calls in TINY_PALLAS training steps on 2
  ranks (tests/torch_ranks.py `model_axis_calls_rank`)."""
  work = str(tmp_path_factory.mktemp('mp_calls'))
  torch_ranks.run_ranks(torch_ranks.model_axis_calls_rank, 2, (work,))
  with open(os.path.join(work, 'calls.json')) as f:
    return json.load(f)


# The sums that a checkpoint's recomputation redoes, per transformer layer
# (the GNNs of TINY are not checkpointed): with PyTorch's early stop the
# recomputation ends at the last tensor the backward needs, and the
# feed-forward's row-parallel sum comes after it (nothing saves its
# output), so a 'full' block redoes only the attention's `out` sum and
# 'save_attention' (the feed-forward half checkpointed) none; without the
# early stop a checkpointed region redoes every sum in it.
RECOMPUTED_PER_LAYER = {('full', True): 1, ('full', False): 2,
                        ('save_attention', True): 0,
                        ('save_attention', False): 1}


@pytest.mark.parametrize('policy,early', sorted(RECOMPUTED_PER_LAYER))
def test_all_reduce_calls_of_a_step_as_derived(calls, policy, early):
  """One training step's all_reduces: in the forward one sum per call of a
  sharded module (each runs once, but mesh2grid's mesh-node MLP, whose
  output nothing decodes, runs not at all); in the backward one gradient
  sum per copy that a gradient reaches (the same modules) plus the sums
  the remat recomputes. At ONE_DEG (save_attention, 16 layers, 39 sharded
  modules) that is 38 + 38 = 76."""
  step = calls['steps'][f'{policy}:{early}']
  sharded = len(calls['sharded'])
  # grid2mesh's edge MLP and both node MLPs; per layer the attention and
  # the feed-forward; mesh2grid's edge MLP, node MLPs and grid decoder.
  assert sharded == 3 + 2 * calls['layers'] + 4
  assert step['no_grad'] == [
      'predictor.denoiser.architecture.mesh2grid.processors.0.node_mlps.'
      'mesh.network']
  assert step['forward'] == sharded - 1
  assert step['backward'] == (sharded - 1 + calls['layers']
                              * RECOMPUTED_PER_LAYER[policy, early])


def _losses(path):
  with open(path) as f:
    return [r['loss'] for r in map(json.loads, f) if r['event'] == 'train']


def _params(ckpt, step):
  return torch.load(os.path.join(ckpt, f'step_{step}.pt'),
                    weights_only=True)['params']


ARGV = ['--device', 'cpu', '--data', 'synthetic', '--log_every', '1',
        '--prefetch', '0']


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
  """The CLIs: one process and --dp 2 --mp 2 at batch 2 (TINY, 2 steps);
  --mp 2 for 2 steps (TINY_PALLAS), then resumed to 3 steps under --mp 2
  and, from a copy, under --mp 1."""
  root = tmp_path_factory.mktemp('mp_cli')
  d = {k: str(root / k) for k in ('one', 'dpmp', 'mp', 'mp_copy')}
  metrics = {k: str(root / f'{k}.jsonl') for k in ('dpmp', 'mp')}
  base = ARGV + ['--preset', 'tiny', '--batch_size', '2', '--steps', '2']
  one = train.main(base + ['--ckpt_dir', d['one']])
  out = {'dpmp': torch_ranks.run_cli(TRAIN, base + [
      '--dp', '2', '--mp', '2', '--ckpt_dir', d['dpmp'], '--metrics_jsonl',
      metrics['dpmp']])}
  pallas = ARGV + ['--preset', 'tiny_pallas', '--metrics_jsonl',
                   metrics['mp'], '--ckpt_dir']
  out['mp'] = torch_ranks.run_cli(TRAIN, pallas + [d['mp'], '--steps', '2',
                                                   '--mp', '2'])
  shutil.copytree(d['mp'], d['mp_copy'])
  out['resume'] = torch_ranks.run_cli(TRAIN, pallas + [
      d['mp'], '--steps', '3', '--mp', '2'])
  resumed = train.main(ARGV + ['--preset', 'tiny_pallas', '--ckpt_dir',
                               d['mp_copy'], '--steps', '3'])
  return dict(dirs=d, one=one, out=out, resumed=resumed,
              losses={k: _losses(v) for k, v in metrics.items()})


def test_dp2_mp2_matches_one_process(cli_runs):
  """4 ranks, (data 2, model 2), against one process at batch 2: the
  losses within LOSS_RTOL and each parameter's change within STEP_RTOL of
  its largest change."""
  out, losses, one = cli_runs['out']['dpmp'], cli_runs['losses'], \
      cli_runs['one']
  assert out.count('[train] multihost: process') == 4
  assert '[train] mesh: data=2 model=2' in out
  assert 'model axis 2: 11 modules sharded' in out
  assert 'run eagerly' in out
  assert out.count('packs 1/2 batch rows') == 4
  np.testing.assert_allclose(losses['dpmp'], one.losses, rtol=LOSS_RTOL)
  start = dict(configs.build_gencast(configs.TINY, seed=0,
                                     device='cpu')[0].named_parameters())
  a, b = (_params(cli_runs['dirs'][k], 1) for k in ('one', 'dpmp'))
  for name, p0 in start.items():
    moved = a[f'predictor.{name}'] - p0.detach()
    assert (float((b[f'predictor.{name}'] - p0.detach() - moved).abs().max())
            <= STEP_RTOL * float(moved.abs().max())), name


def test_mp2_checkpoint_resumes_under_mp2_and_mp1(cli_runs):
  """A checkpoint of --mp 2 resumes under --mp 2 (both ranks) and under
  --mp 1: the next step's loss and parameters agree."""
  out, losses, resumed = (cli_runs['out'], cli_runs['losses']['mp'],
                          cli_runs['resumed'])
  assert out['resume'].count('[train] resumed from step 1') == 2
  assert resumed.start_step == 2 and len(losses) == 3
  assert abs(losses[2] - resumed.losses[0]) <= LOSS_RTOL * abs(losses[2])
  a, b = (_params(cli_runs['dirs'][k], 2) for k in ('mp', 'mp_copy'))
  before = _params(cli_runs['dirs']['mp_copy'], 1)
  for name, p in a.items():
    moved = b[name] - before[name]
    assert (float((p - before[name] - moved).abs().max())
            <= STEP_RTOL * max(float(moved.abs().max()), 1e-30)), name


def test_pod_forecast_ensemble_by_model(tmp_path):
  """4 ranks for 2 members: ensemble 2 x model 2. Each member is saved
  once (by model coordinate 0 of its ensemble coordinate), within POD_RTOL
  of the one-device member; the scores, reduced over the ensemble axis,
  within SCORES_RTOL of ops.metrics on the saved members."""
  out = str(tmp_path / 'forecast.npz')
  argv = ['--preset', 'tiny', '--device', 'cpu', '--members', '2',
          '--steps', '2', '--score', '--out', out]
  stdout = torch_ranks.run_cli('gencast_tpu_torch.scripts.'
                               'ensemble_forecast_pod',
                               argv + ['--num_processes', '4'])
  assert stdout.count('mesh ensemble=2 model=2') == 4
  assert sorted(os.listdir(tmp_path)) == ['forecast.p0.npz',
                                          'forecast.p1.npz',
                                          'forecast.scores.json']
  got = {}
  for e in range(2):
    z = np.load(str(tmp_path / f'forecast.p{e}.npz'))
    assert z['members'].tolist() == [e]
    got[e] = z['predictions'][0]
  args = pod.parse_args(argv)
  wrapped, statics, (inputs, forcings, targets) = pod.build_forecast(
      args, torch.device('cpu'))
  want = ensemble.ensemble_rollout(wrapped, inputs, forcings, seed=0,
                                   num_members=2).numpy()
  for m in range(2):
    assert _rel(got[m], want[m]) <= POD_RTOL, m
  members = torch.as_tensor(np.stack([got[0], got[1]]))
  lat_w = torch.as_tensor(layout_lib.latitude_weights(
      np.asarray(statics.grid_lat)))
  target = wrappers.find_layout_provider(wrapped).target_layout
  reference = {'crps': metrics.crps_ensemble(members, targets, lat_w),
               'rmse': metrics.ensemble_mean_rmse(members, targets, lat_w),
               'spread': metrics.ensemble_spread(members, lat_w)}
  with open(str(tmp_path / 'forecast.scores.json')) as f:
    scores = json.load(f)['scores']
  for name, arr in reference.items():
    for var, v in metrics.per_variable(arr, target).items():
      w, s = np.asarray(v)[:, 0], np.asarray(scores[name][var])
      assert np.abs(s - w).max() <= SCORES_RTOL * np.abs(w).max(), (name,
                                                                    var)


def test_dryrun_multichip_on_four_ranks(monkeypatch):
  """dryrun_multichip(4) on the CPU: mesh (1, 2, 2), every number finite,
  and the toy's loss that of dryrun_multichip(1) (the same global batch
  and draws), within DRYRUN_RTOL."""
  # One thread per spawned rank: they share the CPU's cores.
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  four = dryrun.dryrun_multichip(4, device='cpu')
  one = dryrun.dryrun_multichip(1, device='cpu')
  assert [r['mesh'] for r in four] == [[1, 2, 2]] * 4
  assert one[0]['mesh'] == [1, 1, 1]
  for r in four + one:
    for k in ('loss', 'kernels_loss', 'flash_loss'):
      assert np.isfinite(r[k]), (r['rank'], k)
    assert r['samples'][0] == 2 and r['grad_leaves'] > 0
  assert len({r['loss'] for r in four}) == 1
  assert abs(four[0]['loss'] - one[0]['loss']) <= DRYRUN_RTOL * abs(
      one[0]['loss'])


def test_ar_steps_under_mp2_matches_mp1(tmp_path):
  """--ar_steps 2 under --mp 2 --dp 1 (refused before; the reference runs
  it on one host): TINY GraphCast's 2-step AR losses and the parameters
  after 2 steps within MP_RTOL of --mp 1's. Under --dp 2 it stays refused
  (tests/test_torch_multihost.py)."""
  base = ARGV + ['--model', 'graphcast', '--preset', 'tiny', '--steps', '2',
                 '--ar_steps', '2']
  one = train.main(base + ['--ckpt_dir', str(tmp_path / 'one')])
  metrics = str(tmp_path / 'mp.jsonl')
  out = torch_ranks.run_cli(TRAIN, base + [
      '--mp', '2', '--ckpt_dir', str(tmp_path / 'mp'), '--metrics_jsonl',
      metrics])
  assert '[train] mesh: data=1 model=2' in out
  got = _losses(metrics)
  assert len(got) == len(one.losses) == 2
  np.testing.assert_allclose(got, one.losses, rtol=MP_RTOL)
  a, b = (_params(str(tmp_path / k), 1) for k in ('one', 'mp'))
  assert sorted(a) == sorted(b)
  for name, want in a.items():
    assert _rel(b[name].numpy(), want.numpy()) <= MP_RTOL, name
