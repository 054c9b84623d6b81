"""The port's ensemble scores (`gencast_tpu_torch.ops.metrics`) against the
JAX package's (`gencast_tpu.ops.metrics`) on the same numpy arrays, on CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.data import layout as jax_layout
from gencast_tpu.ops import metrics as jax_metrics
from gencast_tpu_torch.data import layout, registry
from gencast_tpu_torch.ops import metrics
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# float32 on both sides, sums in other orders: max|port - jax| relative to
# the largest value of the score.
RTOL = 1e-6


def _data(m, seed=0):
  rng = np.random.default_rng(seed)
  members = rng.standard_normal((m, 2, 19, 36, 5)).astype(np.float32)
  truth = rng.standard_normal((2, 19, 36, 5)).astype(np.float32)
  lat = np.linspace(-90, 90, 19)
  return members, truth, layout.latitude_weights(lat).astype(np.float32)


def _close(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize('m', [1, 3, 5])
def test_scores_match_jax(m):
  members, truth, w = _data(m)
  jm, jt, jw = (jnp.asarray(x) for x in (members, truth, w))
  tm, tt, tw = (torch.as_tensor(x) for x in (members, truth, w))
  for spread in ('sorted', 'pairwise'):
    _close(metrics.crps_ensemble(tm, tt, tw, spread),
           jax_metrics.crps_ensemble(jm, jt, jw, spread))
  _close(metrics.ensemble_mean_rmse(tm, tt, tw),
         jax_metrics.ensemble_mean_rmse(jm, jt, jw))
  _close(metrics.ensemble_spread(tm, tw), jax_metrics.ensemble_spread(jm, jw))
  # The sorted CRPS against the pairwise one, on the port's side.
  _close(metrics.crps_ensemble(tm, tt, tw, 'sorted'),
         metrics.crps_ensemble(tm, tt, tw, 'pairwise'))
  # Scored a band of latitudes at a time, from numpy, with float64 sums.
  got = metrics.score_ensemble_chunked(members, truth, w, lat_chunk=4)
  want = jax_metrics.score_ensemble_chunked(members, truth, w, lat_chunk=4)
  assert got.keys() == want.keys()
  for k in want:
    _close(got[k], want[k])
  _close(got['crps'], metrics.crps_ensemble(tm, tt, tw))


def test_per_variable_matches_jax():
  task = registry.GENCAST_TASK
  tl = layout.build_layout(task.target_variables, task.pressure_levels, 1)
  jl = jax_layout.build_layout(task.target_variables, task.pressure_levels, 1)
  x = np.random.default_rng(1).standard_normal((2, tl.num_channels))
  got, want = metrics.per_variable(torch.as_tensor(x), tl), \
      jax_metrics.per_variable(x, jl)
  assert got.keys() == want.keys()
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
