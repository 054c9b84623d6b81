"""The port's chunked rollout (`rollout.chunked_rollout`, the reference's
'sample' mode) on CPU, on the tri-block TINY model of
tests/test_torch_rollout.py: a 4-step forecast in chunks of 1, 2 and 3
steps is bitwise the unchunked `sample_rollout`, with the host copies
overlapped or not; and with each step's noise drawn on the JAX side from
the reference's global step keys, it matches the JAX package's
`chunked_rollout`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import rollout as jax_rollout
from gencast_tpu_torch import rollout
from gencast_tpu_torch.parallel import ensemble
from tests.test_torch_rollout import SAMPLE_RTOL, SPEC, models  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 4


def _forcings(data, seed=6):
  """[STEPS, 1, lat, lon, C_frc] forcings from a numpy seed."""
  shape = (STEPS,) + data['forcings'].shape[1:]
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def _jax_draws(jmodel, key):
  """Each step's N + 1 noise fields as the JAX rollout draws them, from the
  reference's global split(key, K) of step keys."""
  out = []
  for step_key in jax.random.split(key, STEPS):
    rest, k0 = jax.random.split(step_key)
    keys = [k0] + list(jax.random.split(rest, SPEC.num_noise_levels))
    out.append([torch.as_tensor(np.array(jmodel._sphere_noise(
        k, 1, jnp.float32))) for k in keys])
  return out


@pytest.mark.parametrize('overlap_offload', [True, False])
@pytest.mark.parametrize('chunk_size', [1, 2, 3])
def test_chunked_rollout_is_the_unchunked_rollout(models, chunk_size,
                                                  overlap_offload):
  """The generator's stream is drawn step after step whatever the chunks,
  so any chunk size gives the unchunked forecast's bits, and the window is
  carried across chunks."""
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(_forcings(data))
  want = rollout.sample_rollout(tstack, inputs, forcings,
                                torch.Generator().manual_seed(5))
  got = rollout.chunked_rollout(
      tstack, inputs, forcings, torch.Generator().manual_seed(5),
      chunk_size=chunk_size, overlap_offload=overlap_offload)
  assert got.device.type == 'cpu' and got.shape == want.shape
  assert torch.equal(got, want)
  assert not torch.equal(got[0], got[-1])


@pytest.mark.parametrize('teacher', [False, True])
def test_chunked_rollout_matches_jax(models, teacher):
  """Against the reference's chunked_rollout at chunk 3 (it pads the 4
  steps to 6; the port runs the last chunk short), with the noise of its
  step keys injected, free-running and teacher-forced."""
  jmodel, jstack, tstack, data = models
  forcings = _forcings(data)
  truth = np.random.default_rng(8).standard_normal(
      forcings.shape[:-1] + (tstack.predictor.target_layout.num_channels,)
  ).astype(np.float32)
  key = jax.random.PRNGKey(17)
  want = jax_rollout.chunked_rollout(
      jstack, jnp.asarray(data['inputs']), jnp.asarray(forcings), key,
      chunk_size=3, teacher_targets=jnp.asarray(truth) if teacher else None)
  got = rollout.chunked_rollout(
      tstack, torch.as_tensor(data['inputs']), torch.as_tensor(forcings),
      chunk_size=3, noise=_jax_draws(jmodel, key),
      teacher_targets=torch.as_tensor(truth) if teacher else None).numpy()
  assert got.shape == want.shape == truth.shape
  assert float(np.abs(got - want).max() / np.abs(want).max()) <= SAMPLE_RTOL


def test_return_final_inputs_is_the_next_window(models):
  """rollout(..., return_final_inputs=True) also gives the window after the
  last step: the inputs from which a further step starts, so two rollouts
  of 2 steps make the one of 4."""
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(_forcings(data))
  gen = torch.Generator().manual_seed(2)
  first, window = rollout.sample_rollout(tstack, inputs, forcings[:2], gen,
                                         return_final_inputs=True)
  second = rollout.sample_rollout(tstack, window, forcings[2:], gen)
  want = rollout.sample_rollout(tstack, inputs, forcings,
                                torch.Generator().manual_seed(2))
  assert window.shape == inputs.shape
  assert torch.equal(torch.cat([first, second]), want)


def test_chunked_members_equal_the_ensemble(models):
  """ensemble_rollout with chunk_size streams each member's steps through
  chunked_rollout: the members' forecasts are unchanged."""
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(_forcings(data))
  want = ensemble.ensemble_rollout(tstack, inputs, forcings, seed=3,
                                   num_members=2)
  got = ensemble.ensemble_rollout(tstack, inputs, forcings, seed=3,
                                  num_members=2, chunk_size=3,
                                  overlap_offload=False)
  assert torch.equal(got, want)


def test_chunked_rollout_takes_only_the_sampled_mode(models):
  """Mode 'predict', refused until GraphCast was ported, rolls a GraphCast
  out deterministically, bitwise the unchunked `predict_rollout`; any other
  mode than 'sample' and 'predict', and a chunk size below 1, are
  refused."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.models import wrappers
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(_forcings(data))
  gc, _ = configs.build_graphcast(configs.TINY, device='cpu', cache_dir=None)
  task = gc.task
  gc_stack = wrappers.build_stack(gc, layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables)),
      task.pressure_levels), bf16=False)
  rng = np.random.default_rng(8)
  gc_inputs = torch.as_tensor(rng.standard_normal(
      (1,) + inputs.shape[1:3] + (gc.input_layout.num_channels,)),
      dtype=torch.float32)
  gc_forcings = torch.as_tensor(rng.standard_normal(
      (STEPS, 1) + inputs.shape[1:3] + (gc.forcing_layout.num_channels,)),
      dtype=torch.float32)
  want = rollout.predict_rollout(gc_stack, gc_inputs, gc_forcings)
  got = rollout.chunked_rollout(gc_stack, gc_inputs, gc_forcings,
                                chunk_size=3, mode='predict')
  assert got.shape == (STEPS, 1) + inputs.shape[1:3] + (
      gc.target_layout.num_channels,)
  assert torch.equal(got, want)
  with pytest.raises(ValueError, match='mode'):
    rollout.chunked_rollout(tstack, inputs, forcings,
                            torch.Generator().manual_seed(0), chunk_size=2,
                            mode='ensemble')
  with pytest.raises(ValueError, match='positive'):
    rollout.chunked_rollout(tstack, inputs, forcings,
                            torch.Generator().manual_seed(0), chunk_size=0)
