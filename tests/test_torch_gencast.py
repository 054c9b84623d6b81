"""The PyTorch port's GenCast against the JAX package, end to end on CPU.

TINY with the block-sparse ('pallas') attention at tile 32 and aggregation
plans gated at max degree 2, so both kernel ops of the port (and both
Pallas kernels of the reference, in interpret mode) are on the path. Every
parameter is perturbed before the comparison: a fresh model has zero
attention/FFW output projections and ~1e-8 FiLM weights, which would hide
any attention error. Inputs come from numpy seeds; the sampler's noise is
drawn by the JAX model and injected into the port.
"""

import dataclasses

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.models import gencast as jax_gencast
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu.models.denoiser import DenoiserConfig as JaxDenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig as JaxTransformer
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.data import layout
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.ops import segment, sparse_attention

SPEC = dataclasses.replace(configs.TINY, attention_tile_size=32,
                           use_agg_plans=True, agg_plan_min_degree=2,
                           stochastic_churn_rate=2.5, num_noise_levels=2)

# max|port - jax| / max|jax|: float32 on both sides; the gap is summation
# order (XLA vs ATen matmuls, online vs two-pass softmax).
DENOISER_RTOL = 1e-4
# Three denoiser calls compound, and churn re-injects noise in between.
SAMPLE_RTOL = 1e-3


def _jax_model(statics):
  return jax_gencast.GenCast(
      SPEC.task, statics,
      JaxTransformer(d_model=SPEC.d_model, num_layers=SPEC.num_layers,
                     num_heads=SPEC.num_heads, ffw_hidden=SPEC.ffw_hidden,
                     attention_type='pallas'),
      denoiser_config=JaxDenoiserConfig(
          latent_size=SPEC.d_model, use_agg_plans=True,
          agg_plan_min_degree=SPEC.agg_plan_min_degree),
      sampler_config=jax_gencast.SamplerConfig(
          stochastic_churn_rate=SPEC.stochastic_churn_rate,
          num_noise_levels=SPEC.num_noise_levels),
      rngs=nnx.Rngs(0))


def _stats(task, seed):
  rng = np.random.default_rng(seed)
  names = sorted(set(task.input_variables + task.target_variables
                     + task.forcing_variables))
  nl = len(task.pressure_levels)

  def table(lo, hi):
    out = {}
    for n in names:
      shape = (nl,) if n in layout.registry.ALL_ATMOSPHERIC_VARS else ()
      out[n] = rng.uniform(lo, hi, shape)
    return out
  mean, std, diffs = table(-1, 1), table(0.5, 2), table(0.5, 2)
  return (jax_layout.Stats(mean, std, diffs), layout.Stats(mean, std, diffs))


@pytest.fixture(scope='module')
def pair():
  lat, lon = jax_configs.grid_for_resolution(SPEC.resolution_deg)
  from gencast_tpu.graph import compiler as jax_compiler
  jstatics = jax_compiler.build_graph_statics(
      SPEC.mesh_splits, lat, lon, attention_k_hop=SPEC.attention_k_hop,
      attention_tile_size=SPEC.attention_tile_size,
      build_triblock_mask=False)
  jmodel = _jax_model(jstatics)
  flat_state = nnx.to_flat_state(nnx.state(jmodel, nnx.Param))
  flat = {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in flat_state}
  flat = bridge.perturbed(flat, seed=7)
  nnx.update(jmodel, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in flat_state]))

  tmodel, _ = configs.build_gencast(SPEC, seed=1)
  bridge.load_reference_params(tmodel, flat)

  d = jmodel.denoiser
  rng = np.random.default_rng(0)
  shape = (1, lat.shape[0], lon.shape[0])
  data = {
      'inputs': rng.standard_normal(shape + (d.input_layout.num_channels,)),
      'targets': rng.standard_normal(shape + (d.target_layout.num_channels,)),
      'forcings': rng.standard_normal(
          shape + (d.forcing_layout.num_channels,)),
  }
  data = {k: v.astype(np.float32) for k, v in data.items()}
  return jmodel, tmodel, data


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


def test_bridge_round_trip(pair):
  _, tmodel, _ = pair
  flat = bridge.export_reference_params(tmodel)
  bridge.load_reference_params(tmodel, flat)
  again = bridge.export_reference_params(tmodel)
  assert flat.keys() == again.keys()
  for k in flat:
    np.testing.assert_array_equal(flat[k], again[k])
  flat.pop(sorted(flat)[0])
  with pytest.raises(KeyError, match='not loaded'):
    bridge.load_reference_params(tmodel, flat)


def test_denoiser_matches_jax(pair, monkeypatch):
  jmodel, tmodel, data = pair
  sigma = np.asarray([1.7], np.float32)
  want = np.asarray(jmodel(jnp.asarray(data['inputs']),
                           jnp.asarray(data['targets']), jnp.asarray(sigma),
                           jnp.asarray(data['forcings'])))
  calls = {'attention': 0, 'segment': 0}

  def spy(name, fn):
    def wrapped(*args, **kwargs):
      calls[name] += 1
      return fn(*args, **kwargs)
    return wrapped

  monkeypatch.setattr(
      sparse_attention, 'sparse_banded_attention_plain',
      spy('attention', sparse_attention.sparse_banded_attention_plain))
  monkeypatch.setattr(
      segment, 'planned_segment_sum_plain',
      spy('segment', segment.planned_segment_sum_plain))
  with torch.no_grad():
    got = tmodel(torch.as_tensor(data['inputs']),
                 torch.as_tensor(data['targets']), torch.as_tensor(sigma),
                 torch.as_tensor(data['forcings'])).numpy()
  assert got.shape == want.shape
  assert _rel(got, want) <= DENOISER_RTOL
  # One attention call per layer, one planned grid2mesh aggregation, all
  # through the wrappers' CPU route (kernels are not launched on the CPU).
  assert calls == {'attention': SPEC.num_layers, 'segment': 1}
  assert sparse_attention.KERNEL.launches == 0
  assert segment.KERNEL.launches == 0


def test_wrapped_sample_matches_jax(pair):
  jmodel, tmodel, data = pair
  jstats, tstats = _stats(SPEC.task, seed=3)
  jstack = jax_wrappers.build_stack(jmodel, jstats, bf16=False)
  tstack = wrappers.build_stack(tmodel, tstats, bf16=False)
  key = jax.random.PRNGKey(11)
  want = np.asarray(jstack.sample(jnp.asarray(data['inputs']),
                                  jnp.asarray(data['forcings']), key))

  # The reference's draws: x0 from the first split, then one field per
  # churn step from split(key, N) (models/gencast.py sample).
  rest, k0 = jax.random.split(key)
  keys = [k0] + list(jax.random.split(rest, SPEC.num_noise_levels))
  noise = [torch.as_tensor(np.array(jmodel._sphere_noise(k, 1,
                                                           jnp.float32)))
           for k in keys]
  got = tstack.sample(torch.as_tensor(data['inputs']),
                      torch.as_tensor(data['forcings']), noise=noise).numpy()
  assert got.shape == want.shape and np.isfinite(got).all()
  assert _rel(got, want) <= SAMPLE_RTOL


def test_sphere_noise_is_unit_variance(pair):
  _, tmodel, _ = pair
  g = torch.Generator().manual_seed(0)
  n = tmodel.sphere_noise(g, 4)
  assert n.shape == (4, 19, 36, tmodel.target_layout.num_channels)
  # Pointwise variance 1 by construction; a 4 x 82-field sample of the
  # 684-point grid estimates it to a few percent.
  assert abs(float(n.var()) - 1.0) < 0.1


def test_bf16_stack_follows_weight_loads(pair):
  """The bf16 stack returns float32, stays near the float32 model, and its
  bf16 parameter copy is remade by refresh() after the master weights are
  reloaded."""
  import copy
  from gencast_tpu_torch.models import casting
  _, tmodel, data = pair
  model = copy.deepcopy(tmodel)
  _, stats = _stats(SPEC.task, seed=5)
  f32 = wrappers.build_stack(model, stats, bf16=False)
  bf16 = wrappers.build_stack(model, stats, bf16=True)
  (cast,) = [m for m in bf16.modules() if isinstance(m, casting.Bfloat16Cast)]
  args = (torch.as_tensor(data['inputs']), torch.as_tensor(data['targets']),
          torch.tensor([2.0]), torch.as_tensor(data['forcings']))
  with torch.no_grad():
    stale = bf16(*args)
    for seed in (0, 1):
      bridge.load_reference_params(model, bridge.perturbed(
          bridge.export_reference_params(tmodel), seed=seed))
      cast.refresh()
      want, got = f32(*args), bf16(*args)
      assert got.dtype == torch.float32 and torch.isfinite(got).all()
      # bf16 activations and weights through 2 layers: ~1e-2 of the range.
      assert _rel(got.numpy(), want.numpy()) < 5e-2
      assert not torch.equal(got, stale)
      stale = got


def test_nan_cleaner_fills_and_reintroduces():
  """NaNs of the cleaned variable are filled before the predictor and put
  back into its predictions where any input frame had them."""
  from gencast_tpu_torch.data import registry

  class Echo(torch.nn.Module):
    task = registry.GENCAST_TASK_FULL

    def __init__(self):
      super().__init__()
      self.input_layout = layout.build_layout(
          self.task.input_variables, self.task.pressure_levels, 2)
      self.target_layout = layout.build_layout(
          self.task.target_variables, self.task.pressure_levels, 1)
      self.forcing_layout = layout.build_layout(
          self.task.forcing_variables, self.task.pressure_levels, 1)
      self.seen = None

    def forward(self, inputs, noisy_targets, noise_levels, forcings):
      self.seen = inputs
      return noisy_targets

  echo = Echo()
  cleaner = wrappers.NaNCleaner(echo, 'sea_surface_temperature', -3.0,
                                reintroduce_nans=True)
  sst_in = echo.input_layout.var_channels('sea_surface_temperature')
  sst_out = echo.target_layout.var_channels('sea_surface_temperature')
  inputs = torch.zeros(1, 2, 3, echo.input_layout.num_channels)
  inputs[0, 1, 2, sst_in[0]] = float('nan')
  targets = torch.ones(1, 2, 3, echo.target_layout.num_channels)
  out = cleaner(inputs, targets, torch.ones(1), torch.zeros(1, 2, 3, 4))
  assert echo.seen[0, 1, 2, sst_in[0]] == -3.0
  assert torch.isfinite(echo.seen).all()
  assert torch.isnan(out[0, 1, 2, sst_out]).all()
  assert torch.isnan(out).sum() == len(sst_out)
