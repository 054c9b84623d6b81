"""The 0.25-degree configuration's machinery in the port, against the JAX
package, on CPU.

QUARTER_DEG is the paper's GenCast with three memory fields: streamed edges
in the encoder and decoder (`edge_chunk_size`), whole-GNN remat
(`remat_gnns`) and the noise basis stored in bf16 (`noise_basis_dtype`).
Its statics take ~25 s and 3 GB of host memory to build and are cached on
disk. Here: the preset's fields against the reference's; the statics cache;
the bf16 basis (the device recursion of the Legendre table and synthesis
with float32 sums) against the JAX package's; and TINY built with all three
memory fields (a chunk of 64 edges, so receivers straddle chunks), the same
perturbed weights and injected draws on both sides: the denoiser, the loss
and its gradients under both remat policies, and the 3-call sampler.
"""

import dataclasses
import os

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.models import gencast as jax_gencast
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu.models.denoiser import DenoiserConfig as JaxDenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig as JaxTransformer
from gencast_tpu.ops import sph_harm as jax_sph
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.data import layout
from gencast_tpu_torch.graph import compiler
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.ops import sph_harm
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# TINY with QUARTER_DEG's memory fields. d_model 128 lets the JAX LN+FiLM
# take its Pallas backward (GENCAST_FUSED_LN_FILM=1, C % 128 == 0), as in
# tests/test_torch_training.py. The chunk of 64 edges cuts grid2mesh's
# 1,236 edges into 20 chunks (a receiver has up to 54 edges) and
# mesh2grid's 2,052 (cut to 63, whole receivers) into 33.
SPEC = dataclasses.replace(
    configs.TINY_PALLAS, d_model=128, attention_tile_size=32,
    edge_chunk_size=64, remat_gnns=True, noise_basis_dtype='bfloat16',
    remat_policy='full', stochastic_churn_rate=2.5, num_noise_levels=2)
REMAT_POLICIES = ('full', 'save_attention')

# Denoiser, max|port - jax| / max|jax|: float32 on both sides (the TINY
# tolerance of the port's first slice).
DENOISER_RTOL = 1e-5
# Loss, relative; gradients per parameter, max|port - jax| <= GRAD_RTOL *
# max|jax| (tests/test_torch_training.py's bounds: float32 through two
# GNNs and two attention layers, sums in other orders).
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
# Three denoiser calls compound, and churn re-injects noise in between.
SAMPLE_RTOL = 1e-3
# The device recursion of the Legendre table, max abs error / table max,
# against the float64 table: the float32 recursion's drift at L = 300
# (2.37e-4 for both packages' recursions). Against the JAX package's
# recursion: the two differ by an ulp in the first rows (XLA's and ATen's
# float32 elementwise ops round differently) and the recursion's drift
# grows that to 8.2e-5 of the table max at L = 300.
TABLE_VS_F64 = 2.4e-4
TABLE_VS_JAX = 1e-4
TABLE_L = 300


def test_quarter_deg_spec_is_the_references():
  """Every field of the reference's QUARTER_DEG, but for the tile (the
  port's 64 for the TPU's 768) and three fields the port has no use for:
  the donated-state step (eager updates are in place), the gradient
  checkpointing switch (the remat policy decides) and the layer scan's
  unroll factor (the port's layers are a Python loop)."""
  jax_spec, spec = jax_configs.QUARTER_DEG, configs.QUARTER_DEG
  assert configs.SPECS['0.25deg'] is spec
  dropped = {'use_donated_step', 'use_gradient_checkpointing', 'scan_unroll'}
  fields = {f.name for f in dataclasses.fields(jax_spec)}
  port_fields = {f.name for f in dataclasses.fields(spec)}
  assert fields - port_fields == dropped
  for name in sorted(fields - dropped - {'attention_tile_size'}):
    want, got = getattr(jax_spec, name), getattr(spec, name)
    if name == 'task':
      want, got = dataclasses.asdict(want), dataclasses.asdict(got)
    assert got == want, name
  assert (jax_spec.attention_tile_size, spec.attention_tile_size) == (768, 64)
  assert jax_spec.use_donated_step and not spec.use_agg_plans


def _arrays(statics):
  """Every array of a GraphStatics, by path."""
  out = {}

  def walk(prefix, obj):
    if isinstance(obj, np.ndarray):
      out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
      for f in dataclasses.fields(obj):
        walk(f'{prefix}.{f.name}', getattr(obj, f.name))
  walk('statics', statics)
  return out


def test_statics_cache_reloads_and_keys(tmp_path):
  """A second build of the same spec loads the first's file, array for
  array; a different tile or k-hop is another key (a new build)."""
  cache = str(tmp_path)
  spec = configs.TINY_PALLAS
  built = configs.build_statics(spec, cache_dir=cache)
  files = os.listdir(cache)
  assert len(files) == 1 and files[0].endswith('.pkl')
  again = configs.build_statics(spec, cache_dir=cache)
  assert os.listdir(cache) == files
  want, got = _arrays(built), _arrays(again)
  assert want.keys() == got.keys() and len(want) > 10
  for k in want:
    assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  fresh = configs.build_statics(spec, cache_dir=None)
  for k, v in _arrays(fresh).items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  for other in (dataclasses.replace(spec, attention_tile_size=64),
                dataclasses.replace(spec, attention_k_hop=3)):
    statics = configs.build_statics(other, cache_dir=cache)
    assert statics.attention_tile_plan.tile == other.attention_tile_size
    assert statics.attention_k_hop == other.attention_k_hop
  assert len(os.listdir(cache)) == 3


def test_device_table_matches_jax_and_float64():
  lat = np.linspace(-90.0, 90.0, 181)
  x = np.sin(np.deg2rad(lat))
  ref = jax_sph.legendre_table(x, TABLE_L)
  want = np.asarray(jax_sph.legendre_table_device(x, TABLE_L, np.float32))
  got = sph_harm.legendre_table_device(x, TABLE_L, torch.float32).numpy()
  assert got.shape == ref.shape
  scale = np.abs(ref).max()
  assert np.abs(got - want).max() <= TABLE_VS_JAX * scale
  assert np.abs(got - ref).max() <= TABLE_VS_F64 * scale
  # The zero structure above the diagonal is kept exactly.
  l_idx = np.arange(TABLE_L + 1)
  assert np.all(got[l_idx[:, None] < l_idx[None, :]] == 0.0)
  # Emitted in bf16, the rows are the float32 ones rounded.
  bf16 = sph_harm.legendre_table_device(x, TABLE_L, torch.bfloat16)
  np.testing.assert_array_equal(
      bf16.float().numpy(), torch.as_tensor(got).bfloat16().float().numpy())


def test_basis_dtype_and_device_gate(monkeypatch):
  """As the reference: the device recursion for a bf16 basis at
  max_l >= 256 (here the gate is lowered to 8), the float64 host table for
  a float32 basis, GENCAST_SH_DEVICE_TABLE forcing either, and each choice
  its own cache entry."""
  lat = np.linspace(-88.0, 88.0, 23)
  lon = np.arange(0.0, 360.0, 15.0)
  monkeypatch.delenv('GENCAST_SH_DEVICE_TABLE', raising=False)
  monkeypatch.setattr(sph_harm, '_DEVICE_TABLE_MIN_L', 8)
  monkeypatch.setattr(jax_sph, '_DEVICE_TABLE_MIN_L', 8)
  for dtype, jdtype in ((torch.float32, np.float32),
                        (torch.bfloat16, jnp.bfloat16)):
    got = sph_harm.basis_for_grid(lat, lon, dtype=dtype)
    want = jax_sph.basis_for_grid(lat, lon, dtype=jdtype)
    assert got.legendre.dtype == got.fourier.dtype == dtype
    assert got.max_l == want.max_l
    g, w = got.legendre.float().numpy(), np.asarray(want.legendre, np.float32)
    if dtype == torch.float32:  # the float64 table, rounded: equal bits
      np.testing.assert_array_equal(g, w)
    else:  # float32 recursions in two engines, rounded to bf16
      assert np.abs(g - w).max() <= 2 ** -8 * np.abs(w).max()
    np.testing.assert_array_equal(got.fourier.float().numpy(),
                                  np.asarray(want.fourier, np.float32))
  monkeypatch.setenv('GENCAST_SH_DEVICE_TABLE', '1')
  forced = sph_harm.basis_for_grid(lat, lon)
  monkeypatch.setenv('GENCAST_SH_DEVICE_TABLE', '0')
  host = sph_harm.basis_for_grid(lat, lon)
  assert forced is not host
  np.testing.assert_allclose(forced.legendre.numpy(), host.legendre.numpy(),
                             atol=1e-5)


def test_bf16_synthesis_matches_jax():
  """`synthesize` with a bf16 basis: coefficients rounded to bf16, float32
  sums, the intermediate rounded to bf16, a float32 result, as the
  reference's. The two differ only where float32 sums in another order
  round the intermediate the other way (one bf16 ulp of it)."""
  lat = np.arange(-90.0, 90.0 + 1e-6, 5.0)
  lon = np.arange(0.0, 360.0, 5.0)
  want_basis = jax_sph.basis_for_grid(lat, lon, dtype=jnp.bfloat16)
  basis = sph_harm.basis_for_grid(lat, lon, dtype=torch.bfloat16)
  n = basis.max_l + 1
  coeffs = np.random.default_rng(0).standard_normal(
      (3, 2, n, n)).astype(np.float32)
  want = np.asarray(jax_sph.synthesize(jnp.asarray(coeffs), want_basis))
  got = sph_harm.synthesize(torch.as_tensor(coeffs), basis.legendre,
                            basis.fourier)
  assert got.dtype == torch.float32 and want.dtype == np.float32
  got = got.numpy()
  # One bf16 ulp of the intermediate, summed over the Fourier contraction.
  assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
  # The float32 basis gives the same field to bf16 precision.
  f32 = sph_harm.basis_for_grid(lat, lon)
  full = sph_harm.synthesize(torch.as_tensor(coeffs), f32.legendre,
                             f32.fourier).numpy()
  assert np.abs(got - full).max() <= 2e-2 * np.abs(full).max()


def _jax_model(statics, remat_policy):
  return jax_gencast.GenCast(
      SPEC.task, statics,
      JaxTransformer(d_model=SPEC.d_model, num_layers=SPEC.num_layers,
                     num_heads=SPEC.num_heads, ffw_hidden=SPEC.ffw_hidden,
                     attention_type='pallas', use_gradient_checkpointing=True,
                     remat_policy=remat_policy),
      denoiser_config=JaxDenoiserConfig(
          latent_size=SPEC.d_model, edge_chunk_size=SPEC.edge_chunk_size,
          remat_gnns=SPEC.remat_gnns),
      sampler_config=jax_gencast.SamplerConfig(
          stochastic_churn_rate=SPEC.stochastic_churn_rate,
          num_noise_levels=SPEC.num_noise_levels),
      rngs=nnx.Rngs(0), noise_basis_dtype=np.dtype(jnp.bfloat16))


def _flat(state):
  return {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in nnx.to_flat_state(state)}


@pytest.fixture(scope='module')
def setup():
  lat, lon = jax_configs.grid_for_resolution(SPEC.resolution_deg)
  jstatics = jax_compiler.build_graph_statics(
      SPEC.mesh_splits, lat, lon, attention_k_hop=SPEC.attention_k_hop,
      attention_tile_size=SPEC.attention_tile_size, build_triblock_mask=False,
      cache_dir=None)
  # The JAX state of the streamed model: its stream tables are not
  # parameters, so the port's strict load takes it as it takes a dense one.
  flat = bridge.perturbed(
      _flat(nnx.state(_jax_model(jstatics, 'full'), nnx.Param)), seed=7)
  statics = compiler.build_graph_statics(
      SPEC.mesh_splits, lat, lon, attention_k_hop=SPEC.attention_k_hop,
      attention_tile_size=SPEC.attention_tile_size)
  rng = np.random.default_rng(3)
  names = sorted(set(SPEC.task.input_variables + SPEC.task.target_variables
                     + SPEC.task.forcing_variables))
  table = lambda lo, hi: {n: rng.uniform(lo, hi, (len(
      SPEC.task.pressure_levels),) if n in layout.registry.ALL_ATMOSPHERIC_VARS
                                     else ()) for n in names}
  mean, std, diffs = table(-1, 1), table(0.5, 2), table(0.5, 2)
  tmodel, _ = configs.build_gencast(SPEC, seed=1, statics=statics,
                                    device='cpu')
  d = tmodel.denoiser
  shape = (1, lat.shape[0], lon.shape[0])
  data = {
      'inputs': rng.standard_normal(shape + (d.input_layout.num_channels,)),
      'targets': rng.standard_normal(shape + (d.target_layout.num_channels,)),
      'forcings': rng.standard_normal(
          shape + (d.forcing_layout.num_channels,))}
  data = {k: v.astype(np.float32) for k, v in data.items()}
  return dict(jstatics=jstatics, statics=statics, flat=flat, data=data,
              jstats=jax_layout.Stats(mean, std, diffs),
              tstats=layout.Stats(mean, std, diffs))


def _pair(setup, remat_policy):
  jmodel = _jax_model(setup['jstatics'], remat_policy)
  flat_state = nnx.to_flat_state(nnx.state(jmodel, nnx.Param))
  nnx.update(jmodel, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(setup['flat']['/'.join(map(str, p))])))
       for p, v in flat_state]))
  tmodel, _ = configs.build_gencast(
      dataclasses.replace(SPEC, remat_policy=remat_policy), seed=1,
      statics=setup['statics'], device='cpu')
  bridge.load_reference_params(tmodel, setup['flat'])
  return (jmodel, jax_wrappers.build_stack(jmodel, setup['jstats'],
                                           bf16=False),
          tmodel, wrappers.build_stack(tmodel, setup['tstats'], bf16=False))


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


def test_streamed_model_is_streamed(setup):
  """The port's model holds the memory fields: both GNNs stream (the chunk
  counts of the docstring), the basis is bf16."""
  _, _, tmodel, _ = _pair(setup, 'full')
  arch = tmodel.denoiser.architecture
  assert arch.remat_gnns
  g2m, m2g = arch.grid2mesh.streams['g2m'], arch.mesh2grid.streams['m2g']
  assert (g2m.chunk, g2m.uniform_k, g2m.num_chunks) == (64, None, 20)
  assert (m2g.chunk, m2g.uniform_k, m2g.num_chunks) == (63, 3, 33)
  assert tmodel.sh_legendre.dtype == torch.bfloat16
  noise = tmodel.sphere_noise(torch.Generator().manual_seed(0), 4)
  assert noise.dtype == torch.float32
  assert abs(float(noise.var()) - 1.0) < 0.1


def test_streamed_denoiser_matches_jax(setup):
  jmodel, _, tmodel, _ = _pair(setup, 'full')
  data = setup['data']
  sigma = np.asarray([1.7], np.float32)
  want = np.asarray(jmodel(jnp.asarray(data['inputs']),
                           jnp.asarray(data['targets']), jnp.asarray(sigma),
                           jnp.asarray(data['forcings'])))
  with torch.no_grad():
    got = tmodel(torch.as_tensor(data['inputs']),
                 torch.as_tensor(data['targets']), torch.as_tensor(sigma),
                 torch.as_tensor(data['forcings'])).numpy()
  assert got.shape == want.shape
  assert _rel(got, want) <= DENOISER_RTOL


@pytest.mark.parametrize('remat_policy', REMAT_POLICIES)
def test_streamed_loss_and_gradients_match_jax(setup, monkeypatch,
                                               remat_policy):
  from tests.test_torch_training import _draws
  monkeypatch.setenv('GENCAST_FUSED_LN_FILM', '1')
  jmodel, jstack, tmodel, tstack = _pair(setup, remat_policy)
  key = jax.random.PRNGKey(5)
  batch = [setup['data'][k] for k in ('inputs', 'targets', 'forcings')]

  @nnx.jit
  def jax_loss_and_grads(stack, inputs, targets, forcings, key):
    def loss_fn(m):
      loss, diags = m.loss(inputs, targets, forcings, key)
      return loss.mean(), diags
    return nnx.value_and_grad(loss_fn, has_aux=True)(stack)

  (jloss, _), jgrads = jax_loss_and_grads(
      jstack, *map(jnp.asarray, batch), key)
  jgrads = {k[len('predictor/'):]: v for k, v in _flat(jgrads).items()}
  loss, _ = tstack.loss(*map(torch.as_tensor, batch), **_draws(jmodel, key))
  loss.mean().backward()
  assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(
      float(jloss))
  tgrads = bridge.export_reference_grads(tmodel)
  assert sorted(tgrads) == sorted(jgrads)
  live = 0
  for k, want in jgrads.items():
    got, scale = tgrads[k], np.abs(want).max()
    if scale == 0:  # the decoder's unused mesh-node update
      assert np.abs(got).max() == 0, k
      continue
    live += 1
    assert np.abs(got - want).max() <= GRAD_RTOL * scale, k
  assert live == len(jgrads) - 6


def test_streamed_sampler_matches_jax(setup):
  """The 3-call sampler of the wrapped model, with the JAX model's draws
  (made from its bf16 basis) injected."""
  jmodel, jstack, _, tstack = _pair(setup, 'full')
  data = setup['data']
  key = jax.random.PRNGKey(11)
  want = np.asarray(jstack.sample(jnp.asarray(data['inputs']),
                                  jnp.asarray(data['forcings']), key))
  rest, k0 = jax.random.split(key)
  keys = [k0] + list(jax.random.split(rest, SPEC.num_noise_levels))
  noise = [torch.as_tensor(np.array(jmodel._sphere_noise(k, 1, jnp.float32)))
           for k in keys]
  got = tstack.sample(torch.as_tensor(data['inputs']),
                      torch.as_tensor(data['forcings']), noise=noise).numpy()
  assert got.shape == want.shape and np.isfinite(got).all()
  assert _rel(got, want) <= SAMPLE_RTOL


@pytest.mark.parametrize('remat_gnns', [True, False])
def test_card_launch_counts_of_a_streamed_step(monkeypatch, remat_gnns):
  """`chip_smoke.py` holds each kernel's launches per training step to
  counts derived from the model (`expected_step_launches`). For a streamed
  model they are counted here on the CPU, with the card's dispatch
  (`segment.adds_atomically` patched to say yes): kernel B's wrapper runs
  once per chunk per receiver sum (in the forward, the chunk's remat and,
  with remat_gnns, the GNN's) and per gather backward, kernel E's once per
  chunk of each LN+FiLM that reaches the loss, at the shapes derived."""
  import chip_smoke
  from gencast_tpu_torch.ops import ln_film, segment
  from gencast_tpu_torch.training import steps
  spec = dataclasses.replace(configs.TINY_PALLAS, edge_chunk_size=64,
                             remat_gnns=remat_gnns)
  model, statics = configs.build_gencast(spec, seed=0, device='cpu')
  task = spec.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  stack = wrappers.build_stack(model, stats, bf16=False)
  d = model.denoiser
  rng = np.random.default_rng(0)
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  batch = [torch.as_tensor(rng.standard_normal(grid + (lay.num_channels,)),
                           dtype=torch.float32)
           for lay in (d.input_layout, d.target_layout, d.forcing_layout)]
  counts = {'B': 0, 'E': []}
  planned, ln_bwd = segment.planned_segment_sum, ln_film.ln_film_bwd

  def count_b(*a, **k):
    counts['B'] += 1
    return planned(*a, **k)

  def count_e(x, dy, scale, batch_axis, *a, **k):
    counts['E'].append(tuple(x.shape))
    return ln_bwd(x, dy, scale, batch_axis, *a, **k)

  monkeypatch.setattr(segment, 'adds_atomically', lambda t: True)
  monkeypatch.setattr(segment, 'planned_segment_sum', count_b)
  monkeypatch.setattr(ln_film, 'ln_film_bwd', count_e)
  optimizer = steps.create_optimizer(stack,
                                     steps.OptimizerConfig(total_steps=10))
  steps.train_step(stack, optimizer, *batch, torch.Generator().manual_seed(1))
  want = chip_smoke.expected_step_launches(model)
  assert counts['B'] == want['segment_sum']
  assert len(counts['E']) == want['ln_film_bwd']
  arch = model.denoiser.architecture
  gnn_shapes = (chip_smoke.streamed_ln_film_shapes(
      arch.grid2mesh, set(arch.grid2mesh.num_nodes))
                + chip_smoke.streamed_ln_film_shapes(
                    arch.mesh2grid, set(arch.mesh2grid.node_decoders)))
  assert sorted(s for s in counts['E'] if s[0] != 1) == sorted(gnn_shapes)
  g2m, m2g = arch.grid2mesh.streams['g2m'], arch.mesh2grid.streams['m2g']
  assert counts['B'] == (g2m.num_chunks * (4 + remat_gnns)
                         + m2g.num_chunks)
