"""Kernel B's plain version and the dense aggregation paths against the JAX
package's segment ops. The CUDA kernel runs only on the card (chip_smoke.py
compares it with this plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.ops import segment as jax_segment
from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.ops import segment
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# max|port - jax| / max|jax|: float32 sums in another order.
RTOL = 1e-5


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('sort_ids', [True, False])
@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
def test_planned_sum_matches_jax(sort_ids, dtype):
  rng = np.random.default_rng(0)
  num_segments, num_edges = 300, 2000
  # Skewed degrees: a few hub segments, as on the mesh side of grid2mesh.
  ids = np.concatenate([rng.integers(0, num_segments, num_edges - 300),
                        np.full(300, 7)]).astype(np.int32)
  ids = np.sort(ids) if sort_ids else rng.permutation(ids)
  data = rng.standard_normal((num_edges, 2, 24)).astype(np.float32)
  ref_plan = jax_segment.build_agg_plan(ids, num_segments)
  want = jax_segment.segment_sum_planned(
      jnp.asarray(data, dtype), ref_plan.device_arrays(), ref_plan.meta,
      f32_accumulate=True)
  port_plan = plans.build_agg_plan(ids, num_segments)
  assert (port_plan.perm is None) == sort_ids
  tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
  got = segment.segment_sum_planned(
      torch.as_tensor(data).to(tdtype), torch.as_tensor(port_plan.row_ptr),
      None if port_plan.perm is None else torch.as_tensor(port_plan.perm),
      f32_accumulate=True)
  assert got.dtype == tdtype and tuple(got.shape) == (num_segments, 2, 24)
  want = np.asarray(want, np.float32)
  got = got.float().numpy()
  if tdtype == torch.float32:
    assert _rel(got, want) <= RTOL
  else:
    # Both sum bf16 inputs in f32 and round once; at most one bf16 ulp.
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_plain_planned_sum_empty_segments():
  ids = np.asarray([1, 1, 4, 4, 4], np.int32)
  plan = plans.build_agg_plan(ids, 6)
  data = torch.arange(10, dtype=torch.float32).reshape(5, 2)
  out = segment.planned_segment_sum(data, torch.as_tensor(plan.row_ptr),
                                    None)
  np.testing.assert_array_equal(
      out.numpy(), [[0, 0], [2, 4], [0, 0], [0, 0], [18, 21], [0, 0]])


@pytest.mark.parametrize('uniform', [True, False])
def test_sorted_sum_and_gather_match_jax(uniform):
  rng = np.random.default_rng(1)
  n = 50
  ids = (np.repeat(np.arange(n), 3) if uniform
         else np.sort(rng.integers(0, n, 150))).astype(np.int32)
  k = plans.uniform_degree(ids, n)
  assert (k == 3) == uniform
  data = rng.standard_normal((150, 1, 8)).astype(np.float32)
  want = jax_segment.sorted_segment_sum(jnp.asarray(data), ids, n)
  got = segment.sorted_segment_sum(torch.as_tensor(data),
                                   torch.as_tensor(ids, dtype=torch.long), n,
                                   uniform_k=k)
  assert _rel(got.numpy(), np.asarray(want)) <= RTOL
  nodes = rng.standard_normal((n, 1, 8)).astype(np.float32)
  np.testing.assert_array_equal(
      segment.gather(torch.as_tensor(nodes),
                     torch.as_tensor(ids, dtype=torch.long), k).numpy(),
      np.asarray(jax_segment.gather(jnp.asarray(nodes), ids)))


def test_kernel_wrapper_rejects_cpu_tensors():
  plan = plans.build_agg_plan(np.asarray([0, 0, 1], np.int32), 2)
  with pytest.raises(ValueError, match='CUDA'):
    segment.planned_segment_sum_cuda(torch.zeros(3, 4),
                                     torch.as_tensor(plan.row_ptr), None)
  # The kernel sums float32 only (callers accumulate with f32_accumulate).
  with pytest.raises(TypeError, match='float32'):
    segment.planned_segment_sum_cuda(torch.zeros(3, 4, dtype=torch.bfloat16),
                                     torch.as_tensor(plan.row_ptr), None)
  assert segment.KERNEL.launches == 0
