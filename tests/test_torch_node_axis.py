"""The grid-node axis (`DenoiserConfig.node_sharding_axis`) on the CPU.

Over 2 spawned gloo ranks (tests/torch_ranks.py `node_axis_rank`, each
with its own timeout): the port at --mp 2 with the grid nodes sharded over
the model axis (TINY: 19 latitude rows, 10 and 9 per rank) against the
unsharded port, on the dense, planned and streamed GNN paths, with and
without whole-GNN remat: the denoiser output, the loss and every gradient;
one case against the JAX model built with `node_sharding_axis='model'` on
a 2-device mesh; the all_reduce calls of a node-sharded step, as derived.
"""

import json
import os

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.models import diffusion_utils as jax_diffusion
from gencast_tpu.models import gencast as jax_gencast
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu.models.denoiser import DenoiserConfig as JaxDenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig as JaxTransformer
from gencast_tpu.parallel import meshes as jax_meshes
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.models.denoiser import rank_edges
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Node-sharded against unsharded, float32: max|a - b| <= MP_RTOL * max|b|
# per array (forward, loss, each gradient); only the order of the float32
# sums differs (the mesh-side sums of grid2mesh as two partial sums, the
# partial gradients of the GNNs' parameters summed over the ranks).
MP_RTOL = 1e-5
# Against the JAX package: the loss and forward within LOSS_RTOL, each
# gradient within GRAD_RTOL of its largest entry (the TINY parity
# tolerances of tests/test_torch_model_axis.py).
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
# The streamed cases' chunk: at least 3 chunks of each edge set per rank.
CHUNK = 256

_BASE = dict(preset='tiny', remat_policy='full', use_agg_plans=False,
             agg_plan_min_degree=32, edge_chunk_size=None)
CASES = {
    f'{path}{"_remat" if remat else ""}': dict(_BASE, remat_gnns=remat,
                                               **fields)
    for path, fields in (('dense', {}),
                         ('planned', dict(use_agg_plans=True,
                                          agg_plan_min_degree=1)),
                         ('streamed', dict(edge_chunk_size=CHUNK)))
    for remat in (False, True)}
JAX_CASE = dict(_BASE, remat_gnns=False)


def _flat(state):
  return {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in nnx.to_flat_state(state)}


def _jax_model():
  """JAX TINY (einsum tri-block) with node_sharding_axis='model',
  perturbed weights; returns (model, its flat weights)."""
  spec = configs.TINY
  lat, lon = jax_configs.grid_for_resolution(spec.resolution_deg)
  statics = jax_compiler.build_graph_statics(
      spec.mesh_splits, lat, lon, attention_k_hop=spec.attention_k_hop,
      cache_dir=None)
  model = jax_gencast.GenCast(
      spec.task, statics,
      JaxTransformer(d_model=spec.d_model, num_layers=spec.num_layers,
                     num_heads=spec.num_heads, ffw_hidden=spec.ffw_hidden,
                     attention_type=spec.attention_type,
                     use_gradient_checkpointing=True, remat_policy='full'),
      denoiser_config=JaxDenoiserConfig(latent_size=spec.d_model,
                                        node_sharding_axis='model'),
      rngs=nnx.Rngs(0))
  state = nnx.to_flat_state(nnx.state(model, nnx.Param))
  flat = bridge.perturbed(_flat(nnx.state(model, nnx.Param)), seed=7)
  nnx.update(model, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in state]))
  return model, flat


def _jax_data(jmodel):
  """Seeded batch-1 inputs, targets, forcings, noisy targets, and the
  noise level and noise JAX's loss draws from PRNGKey(5)."""
  d = jmodel.denoiser
  data = _arrays(d.num_lat, d.num_lon, d.input_layout.num_channels,
                 d.target_layout.num_channels, d.forcing_layout.num_channels)
  nc = jmodel.noise_config
  k_sigma, k_noise = jax.random.split(jax.random.PRNGKey(5))
  data['sigma'] = np.asarray(jax_diffusion.rho_inverse_cdf(
      nc.training_min_noise_level, nc.training_max_noise_level,
      nc.training_noise_level_rho,
      jax.random.uniform(k_sigma, (1,), dtype=jnp.float32)))
  data['noise'] = np.asarray(jmodel._sphere_noise(k_noise, 1, jnp.float32))
  return data


def _arrays(lat, lon, c_in, c_tgt, c_frc):
  rng = np.random.default_rng(0)
  grid = (1, lat, lon)
  data = {'inputs': rng.standard_normal(grid + (c_in,)),
          'targets': rng.standard_normal(grid + (c_tgt,)),
          'forcings': rng.standard_normal(grid + (c_frc,)),
          'noisy': 3.0 * rng.standard_normal(grid + (c_tgt,))}
  return {k: v.astype(np.float32) for k, v in data.items()}


def _jax_side(model, data):
  """The JAX stack on a (1, 1, 2) mesh, shard_model'ed: forward, loss and
  every gradient, keyed as node_axis_step's."""
  task = model.task
  stats = jax_layout.Stats.unit(
      set(task.input_variables) | set(task.target_variables),
      task.pressure_levels)
  stack = jax_wrappers.build_stack(model, stats, bf16=False)
  mesh = jax_meshes.make_mesh(1, 1, 2, devices=jax.devices()[:2])
  batch = [jnp.asarray(data[k]) for k in ('inputs', 'targets', 'forcings')]
  out = {}
  with jax.set_mesh(mesh):
    jax_meshes.shard_model(stack, mesh)
    out['forward'] = np.asarray(stack(
        batch[0], jnp.asarray(data['noisy']), jnp.asarray(data['sigma']),
        batch[2]))

    @nnx.jit
    def loss_and_grads(m, inputs, targets, forcings, key):
      def loss_fn(m_):
        loss, _ = m_.loss(inputs, targets, forcings, key)
        return loss.mean(), loss
      return nnx.value_and_grad(loss_fn, has_aux=True)(m)

    (_, loss), grads = loss_and_grads(stack, *batch, jax.random.PRNGKey(5))
  out['loss'] = np.asarray(loss)
  out.update({f'grad:{k[len("predictor/"):]}': v
              for k, v in _flat(grads).items()})
  return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """The unsharded port for each case here, the JAX side, and the two
  ranks' files."""
  work = str(tmp_path_factory.mktemp('node_axis'))
  one, cases = {}, dict(CASES, jax=JAX_CASE)
  jmodel, jflat = _jax_model()
  jdata = _jax_data(jmodel)
  jax_out = _jax_side(jmodel, jdata)
  for name, case in CASES.items():
    model, stack = torch_ranks.node_axis_stack(case, None)
    d = model.denoiser
    data = _arrays(d.num_lat, d.num_lon, d.input_layout.num_channels,
                   d.target_layout.num_channels,
                   d.forcing_layout.num_channels)
    sigma, noise = model.training_draws(torch.Generator().manual_seed(5), 1)
    data.update(sigma=sigma.numpy(), noise=noise.numpy(), **{
        f'param:{k}': v for k, v in bridge.perturbed(
            bridge.export_reference_params(model), seed=7).items()})
    np.savez(os.path.join(work, f'{name}.npz'), **data)
    model, stack = torch_ranks.node_axis_stack(case, data)
    one.update(torch_ranks.node_axis_step(name, model, stack, data, None))
  np.savez(os.path.join(work, 'jax.npz'), **jdata,
           **{f'param:{k}': v for k, v in jflat.items()})
  with open(os.path.join(work, 'cases.json'), 'w') as f:
    json.dump(cases, f)
  torch_ranks.run_ranks(torch_ranks.node_axis_rank, 2, (work,))
  ranks = [dict(np.load(os.path.join(work, f'rank{r}.npz')))
           for r in range(2)]
  with open(os.path.join(work, 'calls.json')) as f:
    calls = json.load(f)
  return dict(one=one, jax=jax_out, ranks=ranks, calls=calls)


def _rel(got, want) -> float:
  scale = float(np.abs(want).max())
  return float(np.abs(np.asarray(got) - want).max()) / max(scale, 1e-30)


@pytest.mark.parametrize('name', sorted(CASES))
def test_node_sharded_matches_unsharded(runs, name):
  """Each rank computes the unsharded model: the gathered output, the loss
  and every gradient within MP_RTOL of the unsharded port's, on both
  ranks."""
  one = runs['one']
  keys = [k for k in one if k.startswith(f'{name}:')]
  assert len(keys) > 50
  assert any(':grad:' in k and 'grid2mesh' in k for k in keys)
  for got in runs['ranks']:
    for k in keys:
      assert _rel(got[k], one[k]) <= MP_RTOL, k
  # The ranks' rows: 10 and 9 of the 19 latitude rows of 36 nodes.
  rows = [r[f'{name}:rows'].tolist() for r in runs['ranks']]
  assert rows == [[0, 360], [360, 684]]


def test_node_gradients_accumulate_over_passes(runs):
  """After a backward pass that raised midway, two passes with no zeroing
  between them leave twice one pass's gradients on each rank: each pass
  sums over the axis only the partial gradients it adds (not those already
  in .grad), and the raised pass does not keep the next from summing."""
  one = runs['one']
  keys = [k for k in one if k.startswith('dense:grad:')]
  assert any('grid2mesh' in k for k in keys)
  for got in runs['ranks']:
    for k in keys:
      acc = got['accumulate:' + k[len('dense:'):]]
      assert _rel(acc, 2 * one[k]) <= MP_RTOL, k


def test_node_sharded_matches_jax_on_a_model_mesh(runs):
  """The port's node-sharded TINY on 2 ranks against the JAX model built
  with node_sharding_axis='model' on a (1, 1, 2) mesh, same weights."""
  want, got = runs['jax'], runs['ranks'][0]
  for k in ('loss', 'forward'):
    assert _rel(got[f'jax:{k}'], want[k]) <= LOSS_RTOL, k
  grads = [k for k in want if k.startswith('grad:')]
  assert grads and all(f'jax:{k}' in got for k in grads)
  for k in grads:
    assert (np.abs(got[f'jax:{k}'] - want[k]).max()
            <= GRAD_RTOL * max(float(np.abs(want[k]).max()), 1e-30)), k


def test_rank_edges_cover_every_edge_once():
  """The streamed cases' chunk gives each rank at least 3 chunks of each
  edge set, and the ranks' edges partition each edge set."""
  statics = configs.build_statics(configs.TINY)
  g = statics.num_grid_nodes
  for edges in (statics.grid2mesh, statics.mesh2grid):
    topo = type('Topo', (), dict(
        senders=edges.senders, receivers=edges.receivers,
        sender_set='grid' if edges is statics.grid2mesh else 'mesh'))
    halves = [rank_edges(topo, lo, hi) for lo, hi in ((0, 360), (360, g))]
    assert np.array_equal(halves[0] ^ halves[1],
                          np.ones(edges.senders.shape, bool))
    assert min(-(-int(h.sum()) // CHUNK) for h in halves) >= 3


# The sums a checkpoint's recomputation redoes per transformer layer with
# PyTorch's early stop (tests/test_torch_model_axis.py).
RECOMPUTED_PER_LAYER = {'full': 1, 'save_attention': 0}


@pytest.mark.parametrize('policy', sorted(RECOMPUTED_PER_LAYER))
def test_all_reduce_calls_of_a_node_sharded_step_as_derived(runs, policy):
  """A node-sharded step's all_reduces. Forward: grid2mesh's mesh-side
  partial sums (1), the processor's row-parallel sums (2 per layer), the
  output gathered (1). Backward: the gradient of each copy (2 per layer,
  plus the sums the remat recomputes; in grid2mesh and mesh2grid the mesh
  latents that this rank's edges read and the conditioning of its rows: 4)
  and the GNNs' partial gradients, one flat sum (1). At ONE_DEG (16
  layers, save_attention) 34 + 37 = 71."""
  layers = runs['calls']['layers']
  step = runs['calls'][policy]
  assert step['forward'] == 1 + 2 * layers + 1
  assert step['backward'] == (4 + 2 * layers + 1
                              + layers * RECOMPUTED_PER_LAYER[policy])
