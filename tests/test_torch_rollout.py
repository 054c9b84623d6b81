"""The port's rollout (`gencast_tpu_torch.rollout`) and the layout pieces it
needs (`rollout_maps`, `unpack`) against the JAX package, on CPU.

The sampled rollout runs the tri-block TINY model (nano's attention
backend, plain versions of kernels C and D here) with perturbed weights,
two 12-hour steps of 3 denoiser calls with churn; the JAX side's per-step
draws are injected into the port. Other inputs come from numpy seeds.
"""

import dataclasses

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu import rollout as jax_rollout
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.models import gencast as jax_gencast
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu.models.denoiser import DenoiserConfig as JaxDenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig as JaxTransformer
from gencast_tpu_torch import bridge, configs, rollout
from gencast_tpu_torch.data import layout, registry
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.ops import banded_attention
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPEC = dataclasses.replace(configs.TINY_TRIBLOCK, stochastic_churn_rate=2.5,
                           num_noise_levels=2)
STEPS = 2
# max|port - jax| / max|jax| over both steps: float32 on both sides; three
# denoiser calls per step compound, churn re-injects noise in between, and
# the second step starts from the first step's prediction.
SAMPLE_RTOL = 1e-3


def _layouts(lib, task):
  return (lib.build_layout(task.input_variables, task.pressure_levels,
                           task.num_input_frames),
          lib.build_layout(task.target_variables, task.pressure_levels, 1),
          lib.build_layout(task.forcing_variables, task.pressure_levels, 1))


@pytest.mark.parametrize('task', ['gencast', 'gencast_full'])
def test_rollout_maps_and_advance_equal(task):
  jl = _layouts(jax_layout, jax_layout.registry.TASKS[task])
  tl = _layouts(layout, registry.TASKS[task])
  want, got = jax_layout.rollout_maps(*jl), layout.rollout_maps(*tl)
  np.testing.assert_array_equal(want.source, got.source)
  np.testing.assert_array_equal(want.index, got.index)
  rng = np.random.default_rng(0)
  x, p, f = (rng.standard_normal((2, 3, 4, lay.num_channels))
             .astype(np.float32) for lay in tl)
  expected = np.asarray(jax_rollout.advance_inputs(
      jnp.asarray(x), jnp.asarray(p), jnp.asarray(f), want))
  np.testing.assert_array_equal(
      rollout.advance_inputs(torch.as_tensor(x), torch.as_tensor(p),
                             torch.as_tensor(f), got).numpy(), expected)


@pytest.mark.parametrize('teacher', [False, True])
def test_rollout_loop_matches_jax(teacher):
  """The window advance over 3 steps, with the model's predictions or the
  teacher's targets, for a deterministic predictor (prediction = tanh of a
  fixed mix of the input channels plus the forcings)."""
  task = registry.TASKS['gencast']
  tl = _layouts(layout, task)
  maps = layout.rollout_maps(*tl)
  c_in, c_tgt, c_frc = (lay.num_channels for lay in tl)
  rng = np.random.default_rng(1)
  mix = rng.standard_normal((c_in, c_tgt)).astype(np.float32) / c_in
  mix_f = rng.standard_normal((c_frc, c_tgt)).astype(np.float32) / c_frc
  inputs = rng.standard_normal((1, 3, 4, c_in)).astype(np.float32)
  forcings = rng.standard_normal((3, 1, 3, 4, c_frc)).astype(np.float32)
  truth = rng.standard_normal((3, 1, 3, 4, c_tgt)).astype(np.float32)

  def jax_predict(x, f, key):
    return jnp.tanh(x @ mix + f @ mix_f)

  want = np.asarray(jax_rollout.rollout(
      jax_predict, jnp.asarray(inputs), jnp.asarray(forcings),
      jax_layout.rollout_maps(*_layouts(jax_layout, task)),
      jax.random.PRNGKey(0),
      teacher_targets=jnp.asarray(truth) if teacher else None))
  tmix, tmix_f = torch.as_tensor(mix), torch.as_tensor(mix_f)
  got = rollout.rollout(
      lambda x, f, step: torch.tanh(x @ tmix + f @ tmix_f),
      torch.as_tensor(inputs), torch.as_tensor(forcings), maps,
      teacher_targets=torch.as_tensor(truth) if teacher else None).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_unpack_equal():
  task = registry.TASKS['gencast_full']
  jl, tl = (_layouts(lib, task)[0] for lib in (jax_layout, layout))
  packed = np.random.default_rng(2).standard_normal(
      (2, 3, 4, tl.num_channels)).astype(np.float32)
  want = jax_layout.unpack(packed, jl)
  got_np = layout.unpack(packed, tl)
  got_t = layout.unpack(torch.as_tensor(packed), tl)
  assert want.keys() == got_np.keys() == got_t.keys()
  for k in want:
    assert isinstance(got_np[k], np.ndarray)
    np.testing.assert_array_equal(got_np[k], want[k])
    np.testing.assert_array_equal(got_t[k].numpy(), want[k])
  # And it inverts pack (which takes static fields as [lat, lon]).
  fields = layout.unpack(packed[:1], tl)
  fields = {k: v[0] if registry.is_static(k) else v
            for k, v in fields.items()}
  np.testing.assert_array_equal(layout.pack(fields, tl), packed[:1])


@pytest.fixture(scope='module')
def models():
  lat, lon = jax_configs.grid_for_resolution(SPEC.resolution_deg)
  jstatics = jax_compiler.build_graph_statics(
      SPEC.mesh_splits, lat, lon, attention_k_hop=SPEC.attention_k_hop,
      cache_dir=None)
  jmodel = jax_gencast.GenCast(
      SPEC.task, jstatics,
      JaxTransformer(d_model=SPEC.d_model, num_layers=SPEC.num_layers,
                     num_heads=SPEC.num_heads, ffw_hidden=SPEC.ffw_hidden,
                     attention_type='triblock_pallas'),
      denoiser_config=JaxDenoiserConfig(latent_size=SPEC.d_model),
      sampler_config=jax_gencast.SamplerConfig(
          stochastic_churn_rate=SPEC.stochastic_churn_rate,
          num_noise_levels=SPEC.num_noise_levels),
      rngs=nnx.Rngs(0))
  flat_state = nnx.to_flat_state(nnx.state(jmodel, nnx.Param))
  flat = bridge.perturbed({'/'.join(map(str, p)): np.asarray(v.get_value())
                           for p, v in flat_state}, seed=8)
  nnx.update(jmodel, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in flat_state]))
  tmodel, _ = configs.build_gencast(SPEC, seed=1, device='cpu')
  bridge.load_reference_params(tmodel, flat)

  rng = np.random.default_rng(3)
  names = sorted(set(SPEC.task.input_variables + SPEC.task.target_variables
                     + SPEC.task.forcing_variables))
  table = lambda lo, hi: {n: rng.uniform(lo, hi, (len(
      SPEC.task.pressure_levels),) if registry.is_atmospheric(n) else ())
                          for n in names}
  mean, std, diffs = table(-1, 1), table(0.5, 2), table(0.5, 2)
  jstack = jax_wrappers.build_stack(
      jmodel, jax_layout.Stats(mean, std, diffs), bf16=False)
  tstack = wrappers.build_stack(tmodel, layout.Stats(mean, std, diffs),
                                bf16=False)
  d = tmodel.denoiser
  grid = (1, lat.shape[0], lon.shape[0])
  data = {'inputs': rng.standard_normal(grid + (d.input_layout.num_channels,)),
          'forcings': rng.standard_normal(
              (STEPS,) + grid + (d.forcing_layout.num_channels,))}
  data = {k: v.astype(np.float32) for k, v in data.items()}
  return jmodel, jstack, tstack, data


def _jax_draws(jmodel, key):
  """Each step's N + 1 noise fields as the JAX rollout draws them: one key
  per step from split(key, K), then x0's from the first split and one per
  churn step from split(rest, N) (models/gencast.py sample)."""
  out = []
  for step_key in jax.random.split(key, STEPS):
    rest, k0 = jax.random.split(step_key)
    keys = [k0] + list(jax.random.split(rest, SPEC.num_noise_levels))
    out.append([torch.as_tensor(np.array(jmodel._sphere_noise(k, 1,
                                                              jnp.float32)))
                for k in keys])
  return out


def test_sample_rollout_matches_jax(models):
  jmodel, jstack, tstack, data = models
  key = jax.random.PRNGKey(13)
  want = np.asarray(jax_rollout.sample_rollout(
      jstack, jnp.asarray(data['inputs']), jnp.asarray(data['forcings']),
      key, jit=False))
  banded_attention.KERNEL.reset()
  got = rollout.sample_rollout(
      tstack, torch.as_tensor(data['inputs']),
      torch.as_tensor(data['forcings']), noise=_jax_draws(jmodel, key))
  assert got.shape == want.shape == (STEPS,) + data['inputs'].shape[:3] + (
      tstack.predictor.target_layout.num_channels,)
  assert torch.isfinite(got).all()
  got = got.numpy()
  assert float(np.abs(got - want).max() / np.abs(want).max()) <= SAMPLE_RTOL
  # The two steps differ: the second started from the first's prediction.
  assert not np.allclose(got[0], got[1])
  assert banded_attention.KERNEL.launches == 0  # plain versions on the CPU


def test_sample_rollout_needs_one_source_of_noise(models):
  _, _, tstack, data = models
  inputs, forcings = (torch.as_tensor(data[k]) for k in ('inputs',
                                                         'forcings'))
  with pytest.raises(ValueError, match='generator or per-step noise'):
    rollout.sample_rollout(tstack, inputs, forcings)
  with pytest.raises(ValueError, match='noise for 1 steps'):
    rollout.sample_rollout(tstack, inputs, forcings, noise=[[]])
