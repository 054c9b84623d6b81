"""The port's ensemble rollout (`gencast_tpu_torch.parallel.ensemble`)
against the JAX package's per-member rollouts, on CPU.

The JAX ensemble gives member m the key fold_in(key, m)
(`gencast_tpu.parallel.ensemble.member_keys`) and runs a sampled rollout
from it; here each member's per-step noise is drawn on the JAX side from
that key and injected into the port, on the tri-block TINY model of
tests/test_torch_rollout.py (two 12-hour steps of 3 denoiser calls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import rollout as jax_rollout
from gencast_tpu.parallel import ensemble as jax_ensemble
from gencast_tpu_torch.parallel import ensemble
from tests.test_torch_rollout import (SAMPLE_RTOL, STEPS, _jax_draws,
                                      models)  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MEMBERS = 2


@pytest.mark.parametrize('teacher', [False, True])
def test_ensemble_rollout_matches_jax_members(models, teacher):
  jmodel, jstack, tstack, data = models
  rng = np.random.default_rng(4)
  truth = rng.standard_normal(
      (STEPS,) + data['inputs'].shape[:3]
      + (tstack.predictor.target_layout.num_channels,)).astype(np.float32)
  keys = jax_ensemble.member_keys(jax.random.PRNGKey(21), MEMBERS)
  want = np.stack([np.asarray(jax_rollout.sample_rollout(
      jstack, jnp.asarray(data['inputs']), jnp.asarray(data['forcings']),
      k, teacher_targets=jnp.asarray(truth) if teacher else None,
      jit=False)) for k in keys])
  got = ensemble.ensemble_rollout(
      tstack, torch.as_tensor(data['inputs']),
      torch.as_tensor(data['forcings']),
      noise=[_jax_draws(jmodel, k) for k in keys],
      teacher_targets=torch.as_tensor(truth) if teacher else None).numpy()
  assert got.shape == want.shape == (MEMBERS, STEPS) + truth.shape[1:]
  assert float(np.abs(got - want).max() / np.abs(want).max()) <= SAMPLE_RTOL
  assert not np.allclose(got[0], got[1])  # the members differ


def test_member_streams_do_not_depend_on_the_ensemble(models):
  """Member m draws from (seed, m) alone: the first members of a larger
  ensemble, and a member run on its own, equal the smaller ensemble's."""
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(data['forcings'][:1])
  three = ensemble.ensemble_rollout(tstack, inputs, forcings, seed=5,
                                    num_members=3)
  two = ensemble.ensemble_rollout(tstack, inputs, forcings, seed=5,
                                  num_members=2)
  last = ensemble.ensemble_rollout(
      tstack, inputs, forcings, keys=ensemble.member_keys(5, 3)[2:])
  assert torch.equal(three[:2], two) and torch.equal(three[2:], last)
  assert not torch.equal(three[0], three[1])


@pytest.mark.parametrize('member_chunk', [None, 1, 2])
def test_streamed_members_equal_the_stacked_ensemble(models, member_chunk):
  """Members go to the host as they end, one at a time or `member_chunk` at
  a time; the result is bitwise the stack of the members' own rollouts, on
  the host, however they were grouped (3 members: the last group of 2 is
  short)."""
  from gencast_tpu_torch import rollout
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(data['forcings'])
  stacked = torch.stack([
      rollout.sample_rollout(tstack, inputs, forcings, key)
      for key in ensemble.member_keys(9, 3)])
  got = ensemble.ensemble_rollout(tstack, inputs, forcings, seed=9,
                                  num_members=3, member_chunk=member_chunk)
  assert got.device.type == 'cpu' and torch.equal(got, stacked)


def test_member_chunk_must_be_positive(models):
  _, _, tstack, data = models
  with pytest.raises(ValueError, match='member_chunk'):
    ensemble.ensemble_rollout(tstack, torch.as_tensor(data['inputs']),
                              torch.as_tensor(data['forcings']), seed=9,
                              num_members=2, member_chunk=-1)


@pytest.mark.parametrize('m', [1, 3])
def test_ensemble_statistics_match_jax(m):
  members = np.random.default_rng(m).standard_normal(
      (m, 2, 5, 6, 3)).astype(np.float32)
  want = jax_ensemble.ensemble_statistics(jnp.asarray(members))
  got = ensemble.ensemble_statistics(torch.as_tensor(members))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                               atol=1e-7)
