"""The PyTorch port's GraphCast against the JAX package, on the CPU.

At the size of the JAX package's own GraphCast tests
(`tests/test_graphcast_model.py`): a 30-degree grid, mesh splits 2 (the
multimesh of levels 0-2), latent 32, 3 message-passing steps. The JAX
model's parameters are perturbed and carried into the port through
`bridge` (its LayerNorm scales and biases too); inputs come from numpy
seeds. Neither model reaches a kernel here: the JAX GraphCast plans
nothing (use_agg_plans is off, as in `build_graphcast`), and the port's
card-only plans apply on the card alone.
"""

import copy
import dataclasses

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import rollout as jax_rollout
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.data import registry as jax_registry
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.models import graphcast as jax_gc
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu_torch import bridge, configs, rollout
from gencast_tpu_torch.data import layout, registry
from gencast_tpu_torch.graph import compiler
from gencast_tpu_torch.models import casting, graphcast, wrappers
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY_GC_TASK = registry.TaskSpec(
    input_variables=('2m_temperature', 'temperature',
                     'toa_incident_solar_radiation', 'year_progress_sin',
                     'land_sea_mask'),
    target_variables=('2m_temperature', 'temperature'),
    forcing_variables=('toa_incident_solar_radiation', 'year_progress_sin'),
    pressure_levels=(500, 1000),
    num_input_frames=2,
)
JAX_TASK = jax_registry.TaskSpec(**dataclasses.asdict(TINY_GC_TASK))
LAT = np.arange(-90.0, 90.0 + 1e-6, 30.0, dtype=np.float32)
LON = np.arange(0.0, 360.0, 30.0, dtype=np.float32)

# max|port - jax| / max|jax| at float32: the gap is summation order (XLA
# against ATen matmuls and reductions).
PREDICT_RTOL = 1e-5
GRAD_RTOL = 1e-4
# The bf16 stacks: bf16 activations and weights through 3 steps, ~1e-2 of
# the range (the GenCast bf16 tests' bounds).
BF16_RTOL = 5e-2
BF16_GRAD_RTOL = 0.1


def _config(**overrides):
  return graphcast.GraphCastConfig(latent_size=32, gnn_msg_steps=3,
                                   **overrides)


def _port_model(statics, flat, **overrides):
  model = graphcast.GraphCast(TINY_GC_TASK, statics, _config(**overrides),
                              rng=torch.Generator().manual_seed(0))
  bridge.load_reference_params(model, flat)
  return model


@pytest.fixture(scope='module')
def pair():
  jstatics = jax_compiler.build_graph_statics(
      2, LAT, LON, build_attention_mask=False, build_multimesh=True)
  statics = compiler.build_graph_statics(2, LAT, LON, build_multimesh=True)
  jmodel = jax_gc.GraphCast(
      JAX_TASK, jstatics, jax_gc.GraphCastConfig(latent_size=32,
                                                 gnn_msg_steps=3),
      rngs=nnx.Rngs(0))
  flat_state = nnx.to_flat_state(nnx.state(jmodel, nnx.Param))
  flat = {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in flat_state}
  flat = bridge.perturbed(flat, seed=7)
  nnx.update(jmodel, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in flat_state]))
  return dict(jstatics=jstatics, statics=statics, jmodel=jmodel, flat=flat,
              model=_port_model(statics, flat))


def _data(model, batch=2, seed=0, k_steps=None):
  """inputs [B, ...], targets and forcings [B, ...] or [K, B, ...]."""
  rng = np.random.default_rng(seed)
  lead = (batch,) if k_steps is None else (k_steps, batch)

  def r(shape):
    return rng.standard_normal(shape).astype(np.float32)
  grid = (LAT.size, LON.size)
  return (r((batch,) + grid + (model.input_layout.num_channels,)),
          r(lead + grid + (model.target_layout.num_channels,)),
          r(lead + grid + (model.forcing_layout.num_channels,)))


def _rel(got, want):
  return float(np.abs(np.asarray(got) - np.asarray(want)).max()
               / np.abs(np.asarray(want)).max())


def _jax_grads(grads):
  return {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in nnx.to_flat_state(grads)}


def _assert_grads_close(port_module, jax_grads, rtol):
  got = bridge.export_reference_grads(port_module)
  assert got.keys() == jax_grads.keys()
  for k, want in jax_grads.items():
    scale = float(np.abs(want).max())
    assert float(np.abs(got[k] - want).max()) <= rtol * max(scale, 1e-30), k


def _units():
  names = set(TINY_GC_TASK.input_variables) | set(
      TINY_GC_TASK.target_variables)
  return (jax_layout.Stats.unit(names, TINY_GC_TASK.pressure_levels),
          layout.Stats.unit(names, TINY_GC_TASK.pressure_levels))


def test_multimesh_statics_equal(pair):
  """The multimesh (and everything else the GraphCast statics hold) equals
  the JAX compiler's, array for array; its edge count is the sum over the
  levels of 3 x 20 x 4^s."""
  ref, port = pair['jstatics'], pair['statics']
  mm = port.multimesh_edges
  assert mm.num_edges == sum(3 * 20 * 4 ** s for s in range(3))
  assert mm.senders.max() < port.num_mesh_nodes
  for name in ('multimesh_edges', 'grid2mesh', 'mesh_edges', 'mesh2grid'):
    for field in ('senders', 'receivers', 'features'):
      a = getattr(getattr(port, name), field)
      b = getattr(getattr(ref, name), field)
      assert a.dtype == b.dtype, (name, field)
      np.testing.assert_array_equal(a, b, err_msg=f'{name}.{field}')
  assert port.attention_tile_plan is None and port.attention_mask is None


def test_predict_and_loss_equal_jax(pair):
  jmodel, model = pair['jmodel'], pair['model']
  x, y, f = _data(model)
  want = np.asarray(nnx.jit(lambda m, a, b: m.predict(a, b))(
      jmodel, jnp.asarray(x), jnp.asarray(f)))
  got = model.predict(torch.as_tensor(x), torch.as_tensor(f))
  assert got.shape == y.shape
  assert _rel(got.detach().numpy(), want) < PREDICT_RTOL
  jloss, jdiags = nnx.jit(lambda m, *a: m.loss(*a))(
      jmodel, jnp.asarray(x), jnp.asarray(y), jnp.asarray(f))
  loss, diags = model.loss(torch.as_tensor(x), torch.as_tensor(y),
                           torch.as_tensor(f))
  np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                             rtol=PREDICT_RTOL)
  assert diags.keys() == jdiags.keys()
  for k in diags:
    np.testing.assert_allclose(diags[k].detach().numpy(),
                               np.asarray(jdiags[k]), rtol=PREDICT_RTOL)


def test_parameter_gradients_equal_jax(pair):
  jmodel, flat = pair['jmodel'], pair['flat']
  model = _port_model(pair['statics'], flat)
  x, y, f = _data(model, seed=1)

  def loss_fn(m):
    loss, _ = m.loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(f))
    return loss.mean()

  _, grads = nnx.jit(nnx.value_and_grad(loss_fn))(jmodel)
  loss, _ = model.loss(torch.as_tensor(x), torch.as_tensor(y),
                       torch.as_tensor(f))
  loss.mean().backward()
  _assert_grads_close(model, _jax_grads(grads), GRAD_RTOL)
  # Every parameter has a gradient, the LayerNorms' included.
  assert any(k.endswith('layer_norm/scale') for k in _jax_grads(grads))


def test_agg_plans_equal_jax(pair):
  """use_agg_plans with a degree gate of 2 plans every skewed side of the
  three GNNs, as the JAX model does (its kernel B in interpret mode here):
  predict, loss and gradients stay the JAX model's."""
  jm = jax_gc.GraphCast(
      JAX_TASK, pair['jstatics'], jax_gc.GraphCastConfig(
          latent_size=32, gnn_msg_steps=3, use_agg_plans=True,
          agg_plan_min_degree=2),
      rngs=nnx.Rngs(0))
  nnx.update(jm, nnx.state(pair['jmodel'], nnx.Param))
  model = _port_model(pair['statics'], pair['flat'], use_agg_plans=True,
                      agg_plan_min_degree=2)
  planned = [t.name for gnn in (model.grid2mesh, model.mesh_gnn,
                                model.mesh2grid)
             for t in gnn.topologies if t.recv_plan or t.sender_plan]
  assert planned == [t.name for t in jm.grid2mesh.topologies + \
                     jm.mesh_gnn.topologies + jm.mesh2grid.topologies
                     if t.recv_plan or t.sender_plan]
  assert 'mesh' in planned
  x, y, f = _data(model, seed=3)

  def loss_fn(m):
    loss, _ = m.loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(f))
    return loss.mean()

  want = np.asarray(nnx.jit(lambda m, a, b: m.predict(a, b))(
      jm, jnp.asarray(x), jnp.asarray(f)))
  with torch.no_grad():
    got = model.predict(torch.as_tensor(x), torch.as_tensor(f))
  assert _rel(got.numpy(), want) < PREDICT_RTOL
  jloss, grads = nnx.jit(nnx.value_and_grad(loss_fn))(jm)
  loss, _ = model.loss(torch.as_tensor(x), torch.as_tensor(y),
                       torch.as_tensor(f))
  loss.mean().backward()
  np.testing.assert_allclose(float(loss.mean().detach()), float(jloss),
                             rtol=PREDICT_RTOL)
  _assert_grads_close(model, _jax_grads(grads), GRAD_RTOL)


def test_bridge_round_trip_keeps_layer_norm_scales(pair):
  flat = bridge.export_reference_params(pair['model'])
  assert flat.keys() == pair['flat'].keys()
  for k, v in pair['flat'].items():
    np.testing.assert_array_equal(flat[k], v, err_msg=k)
  assert any(k.endswith('layer_norm/scale') for k in flat)


def test_m2g_edge_normalization_factor(pair):
  """The factor changes the mesh2grid features as the JAX model's, and the
  statics' own longest edge as the factor leaves them as they are."""
  jstatics, statics, flat = pair['jstatics'], pair['statics'], pair['flat']
  for factor in (0.1, 1.0):
    jm = jax_gc.GraphCast(
        JAX_TASK, jstatics, jax_gc.GraphCastConfig(
            latent_size=32, gnn_msg_steps=3,
            mesh2grid_edge_normalization_factor=factor),
        rngs=nnx.Rngs(0))
    model = _port_model(statics, flat,
                        mesh2grid_edge_normalization_factor=factor)
    np.testing.assert_allclose(model.m2g_edge_feats.numpy(),
                               np.asarray(jm.m2g_edge_feats[...]),
                               rtol=1e-6, atol=1e-7)
  raw_max = float(model.m2g_edge_feats[:, 0].abs().max())
  same = _port_model(statics, flat,
                     mesh2grid_edge_normalization_factor=raw_max)
  np.testing.assert_allclose(same.m2g_edge_feats.numpy(),
                             pair['model'].m2g_edge_feats.numpy(),
                             rtol=1e-5, atol=1e-7)
  x, _, f = _data(pair['model'], batch=1)
  scaled = _port_model(statics, flat, mesh2grid_edge_normalization_factor=0.1)
  with torch.no_grad():
    assert not torch.allclose(scaled.predict(torch.as_tensor(x),
                                             torch.as_tensor(f)),
                              pair['model'].predict(torch.as_tensor(x),
                                                    torch.as_tensor(f)))


@pytest.mark.parametrize('remat_group', [1, 2, 3])
def test_remat_equals_no_remat(pair, remat_group):
  """remat (the encoder and decoder as whole GNNs, each processor step, and
  with remat_group > 1 nested groups of steps; 2 over 3 steps leaves a
  ragged last group) recomputes what it dropped: the loss and every
  gradient are the unrematted model's at float32."""
  plain = _port_model(pair['statics'], pair['flat'])
  rem = _port_model(pair['statics'], pair['flat'], remat=True,
                    remat_group=remat_group)
  x, y, f = (torch.as_tensor(a) for a in _data(plain, seed=2))
  losses = []
  for model in (plain, rem):
    loss, _ = model.loss(x, y, f)
    loss.mean().backward()
    losses.append(loss.detach())
  assert torch.equal(losses[0], losses[1])
  for (name, p), q in zip(plain.named_parameters(), rem.parameters()):
    torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-9,
                               msg=name)


def test_remat_group_implies_remat():
  """An explicit remat_group > 1 turns remat on (grouping needs it), and an
  explicit remat=False is kept, as in the JAX package's build_graphcast."""
  assert not configs.TINY.remat_gnns
  model, statics = configs.build_graphcast(configs.TINY, device='cpu',
                                           cache_dir=None, remat_group=2)
  assert model.config.remat and model.mesh_gnn.remat_steps
  assert model.mesh_gnn.remat_group == 2
  off, _ = configs.build_graphcast(configs.TINY, device='cpu',
                                   statics=statics, remat_group=2,
                                   remat=False)
  assert not off.mesh_gnn.remat_steps
  # The preset's GenCast task becomes GraphCast's variables at its levels.
  want = dataclasses.replace(registry.GRAPHCAST_TASK_13,
                             pressure_levels=configs.TINY.task.pressure_levels)
  assert model.task == want
  assert statics.multimesh_edges is not None


def test_autoregressive_loss_equals_jax(pair):
  """K = 3 steps with the window advanced on the model's predictions: the
  mean loss, the diagnostics and every gradient equal the JAX package's,
  with and without the per-step remat."""
  jstats, stats = _units()
  jwrapped = jax_wrappers.InputsAndResiduals(pair['jmodel'], jstats)
  x, y, f = _data(pair['model'], k_steps=3, seed=3)

  def loss_fn(m):
    loss, diags = jax_rollout.autoregressive_loss(
        m, jnp.asarray(x), jnp.asarray(y), jnp.asarray(f))
    return loss.mean(), diags

  (jloss, jdiags), jgrads = nnx.jit(nnx.value_and_grad(
      loss_fn, has_aux=True))(jwrapped)
  for remat in (True, False):
    wrapped = wrappers.InputsAndResiduals(
        _port_model(pair['statics'], pair['flat']), stats)
    loss, diags = rollout.autoregressive_loss(
        wrapped, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(f),
        remat=remat)
    loss.mean().backward()
    np.testing.assert_allclose(float(loss.detach().mean()), float(jloss),
                               rtol=1e-5)
    assert diags.keys() == jdiags.keys()
    for k in diags:
      np.testing.assert_allclose(diags[k].detach().numpy(),
                                 np.asarray(jdiags[k]), rtol=1e-5)
    _assert_grads_close(wrapped, _jax_grads(jgrads), GRAD_RTOL)
  # The multi-step loss is not the first step's.
  single, _ = wrapped.loss(*(torch.as_tensor(a) for a in (x, y[0], f[0])))
  assert not torch.allclose(single.mean(), loss.mean())


@pytest.mark.parametrize('teacher', [False, True])
def test_predict_rollout_equals_jax(pair, teacher):
  jstats, stats = _units()
  jwrapped = jax_wrappers.InputsAndResiduals(pair['jmodel'], jstats)
  wrapped = wrappers.InputsAndResiduals(pair['model'], stats)
  x, y, f = _data(pair['model'], k_steps=4, seed=4)
  want = np.asarray(jax_rollout.predict_rollout(
      jwrapped, jnp.asarray(x), jnp.asarray(f),
      teacher_targets=jnp.asarray(y) if teacher else None))
  got = rollout.predict_rollout(
      wrapped, torch.as_tensor(x), torch.as_tensor(f),
      teacher_targets=torch.as_tensor(y) if teacher else None)
  assert got.shape == y.shape
  assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('chunk_size', [1, 3])
def test_chunked_predict_equals_unchunked(pair, chunk_size):
  _, stats = _units()
  wrapped = wrappers.InputsAndResiduals(pair['model'], stats)
  x, y, f = (torch.as_tensor(a) for a in _data(pair['model'], k_steps=4,
                                                seed=5))
  for teacher in (None, y):
    want = rollout.predict_rollout(wrapped, x, f, teacher_targets=teacher)
    got = rollout.chunked_rollout(wrapped, x, f, chunk_size=chunk_size,
                                  mode='predict', teacher_targets=teacher)
    assert not got.is_cuda and torch.equal(got, want)


def test_bf16_stack_near_jax_and_f32(pair):
  """The bf16 stack's forecast (Bfloat16Cast.predict, float32 out) stays
  within the GenCast bf16 bound of the JAX bf16 stack's and of the float32
  one, and its loss's gradients reach the float32 masters near the float32
  gradients."""
  jstats, stats = _units()
  model = copy.deepcopy(pair['model'])
  jbf16 = jax_wrappers.build_stack(pair['jmodel'], jstats, bf16=True)
  bf16 = wrappers.build_stack(model, stats, bf16=True)
  f32 = wrappers.build_stack(model, stats, bf16=False)
  assert any(isinstance(m, casting.Bfloat16Cast) for m in bf16.modules())
  x, y, f = _data(model, seed=6)
  want = np.asarray(nnx.jit(lambda m, a, b: m.predict(a, b))(
      jbf16, jnp.asarray(x), jnp.asarray(f)))
  with torch.no_grad():
    got = bf16.predict(torch.as_tensor(x), torch.as_tensor(f))
    exact = f32.predict(torch.as_tensor(x), torch.as_tensor(f))
  assert got.dtype == torch.float32 and torch.isfinite(got).all()
  assert _rel(got.numpy(), want) < BF16_RTOL
  assert _rel(got.numpy(), exact.numpy()) < BF16_RTOL
  batch = [torch.as_tensor(a) for a in (x, y, f)]
  f32.loss(*batch)[0].mean().backward()
  grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
           for n, p in model.named_parameters()}
  model.zero_grad()
  loss, _ = bf16.loss(*batch)
  assert loss.dtype == torch.float32
  loss.mean().backward()
  for n, p in model.named_parameters():
    scale = float(grads[n].abs().max())
    if scale == 0:  # the decoder's unused mesh-node update
      continue
    assert p.grad.dtype == torch.float32, n
    assert float((p.grad - grads[n]).abs().max()) <= BF16_GRAD_RTOL * scale, n


@pytest.mark.parametrize('case', [
    dict(), dict(remat=True), dict(remat=True, remat_group=2),
    dict(remat=True, remat_group=2, gnn_msg_steps=5),
    dict(edge_chunk_size=64, remat=True, remat_group=3, gnn_msg_steps=4),
    dict(edge_chunk_size=64), dict(ar_steps=2),
    dict(ar_steps=3, remat=True, remat_group=2, gnn_msg_steps=3),
])
def test_card_launch_counts(monkeypatch, case):
  """`chip_smoke.py` holds kernel B's launches per GraphCast forward and
  training step to counts derived from the model (`graphcast_b_launches`),
  and every other kernel's to 0. Counted here on the CPU with the card's
  dispatch (`segment.adds_atomically` patched to say yes): B's wrapper runs
  once per planned receiver sum each time a net runs forward (the
  recomputations of remat, of its groups, of streamed chunks and of the
  AR steps included) and once per planned gather's backward; the LN+FiLM
  backward (kernel E) never runs."""
  import chip_smoke
  from gencast_tpu_torch.ops import ln_film, segment
  from gencast_tpu_torch.training import steps
  case = dict(case)
  ar_steps = case.pop('ar_steps', 1)
  model, _ = configs.build_graphcast(configs.TINY, device='cpu',
                                     cache_dir=None, **case)
  _, stats = _units()
  stats = layout.Stats.unit(sorted(set(model.task.input_variables
                                       + model.task.target_variables)),
                            model.task.pressure_levels)
  stack = wrappers.build_stack(model, stats, bf16=False)
  rng = np.random.default_rng(0)
  k = (ar_steps, 1) if ar_steps > 1 else (1,)
  grid = (model.num_lat, model.num_lon)
  batch = [torch.as_tensor(rng.standard_normal(lead + grid + (n,)),
                           dtype=torch.float32)
           for lead, n in (((1,), model.input_layout.num_channels),
                           (k, model.target_layout.num_channels),
                           (k, model.forcing_layout.num_channels))]
  counts = {'B': 0, 'E': 0}
  planned, ln_bwd = segment.planned_segment_sum, ln_film.ln_film_bwd

  def count_b(*a, **kw):
    counts['B'] += 1
    return planned(*a, **kw)

  def count_e(*a, **kw):
    counts['E'] += 1
    return ln_bwd(*a, **kw)

  monkeypatch.setattr(segment, 'adds_atomically', lambda t: True)
  monkeypatch.setattr(segment, 'planned_segment_sum', count_b)
  monkeypatch.setattr(ln_film, 'ln_film_bwd', count_e)
  with torch.no_grad():
    stack.predict(batch[0], batch[2][0] if ar_steps > 1 else batch[2])
  assert counts['B'] == chip_smoke.graphcast_b_launches(model, train=False)
  counts['B'] = 0
  optimizer = steps.create_optimizer(stack,
                                     steps.OptimizerConfig(total_steps=10))
  if ar_steps > 1:
    steps.ar_train_step(stack, optimizer, *batch)
  else:
    steps.train_step(stack, optimizer, *batch)
  want = chip_smoke.graphcast_launches(model, train=True, ar_steps=ar_steps)
  assert counts['B'] == want['segment_sum'] > 0
  assert counts['E'] == 0 and sum(want.values()) == want['segment_sum']
