"""Backwards of the planned aggregation ops against the JAX package's VJPs.

`segment_sum_planned`'s backward is a gather at the segment ids and
`gather_planned`'s backward is the planned segment sum (kernel B on the
card; its plain version here), in float32 when the cotangent is bf16: no
scatter in either direction, as in the reference.
"""

import jax
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


def _skewed_ids(num_segments, num_edges, sort, seed=0):
  rng = np.random.default_rng(seed)
  ids = np.concatenate([rng.integers(0, num_segments, num_edges - 300),
                        np.full(300, 7)]).astype(np.int32)
  return np.sort(ids) if sort else rng.permutation(ids)


def _port_plan(ids, num_segments):
  plan = plans.build_agg_plan(ids, num_segments)
  return (torch.as_tensor(plan.row_ptr),
          None if plan.perm is None else torch.as_tensor(plan.perm))


@pytest.mark.parametrize('sort_ids', [True, False])
def test_segment_sum_planned_backward_matches_jax(sort_ids):
  n, e = 300, 2000
  ids = _skewed_ids(n, e, sort_ids)
  rng = np.random.default_rng(1)
  data = rng.standard_normal((e, 2, 24)).astype(np.float32)
  g = rng.standard_normal((n, 2, 24)).astype(np.float32)
  ref_plan = jax_segment.build_agg_plan(ids, n)
  _, vjp = jax.vjp(lambda x: jax_segment.segment_sum_planned(
      x, ref_plan.device_arrays(), ref_plan.meta), jnp.asarray(data))
  (want,) = vjp(jnp.asarray(g))
  x = torch.tensor(data, requires_grad=True)
  out = segment.segment_sum_planned(x, *_port_plan(ids, n))
  out.backward(torch.as_tensor(g))
  # A gather: exactly the cotangent rows, no arithmetic.
  np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize('sort_ids', [True, False])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gather_planned_backward_is_the_planned_sum(sort_ids, dtype,
                                                    monkeypatch):
  n, e = 300, 2000
  ids = _skewed_ids(n, e, sort_ids, seed=2)
  rng = np.random.default_rng(3)
  nodes = rng.standard_normal((n, 2, 24)).astype(np.float32)
  g = rng.standard_normal((e, 2, 24)).astype(np.float32)
  jdtype = jnp.float32 if dtype == 'float32' else jnp.bfloat16
  ref_plan = jax_segment.build_agg_plan(ids, n)
  _, vjp = jax.vjp(lambda x: jax_segment.gather_planned(
      x, jnp.asarray(ids), ref_plan.device_arrays(), ref_plan.meta),
      jnp.asarray(nodes, jdtype))
  (want,) = vjp(jnp.asarray(g, jdtype))
  want = np.asarray(want, np.float32)

  sums = []
  plain = segment.planned_segment_sum_plain

  def spy(data, row_ptr, perm):
    sums.append(data.dtype)
    return plain(data, row_ptr, perm)
  monkeypatch.setattr(segment, 'planned_segment_sum_plain', spy)

  tdtype = getattr(torch, dtype)
  x = torch.tensor(nodes).to(tdtype).requires_grad_(True)
  out = segment.gather_planned(x, torch.as_tensor(ids, dtype=torch.long),
                               *_port_plan(ids, n))
  np.testing.assert_array_equal(out.detach().float().numpy(),
                                np.asarray(x.detach().float())[ids])
  out.backward(torch.as_tensor(g).to(tdtype))
  # The backward went through the planned sum once, in float32 even for a
  # bf16 cotangent.
  assert sums == [torch.float32]
  assert x.grad.dtype == tdtype
  got = x.grad.float().numpy()
  if dtype == 'float32':
    assert _rel(got, want) <= RTOL
  else:
    # Both sum the bf16 cotangent in f32 and round once: one bf16 ulp.
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
  assert segment.KERNEL.launches == 0


def test_gnn_buffers_both_plans():
  """An InteractionNetwork keeps the sender plan (the 1-degree mesh2grid
  sender gather) as well as the receiver plan, for its backward."""
  from gencast_tpu_torch.nn import gnn
  rng = np.random.default_rng(4)
  senders = _skewed_ids(50, 1000, sort=False, seed=5)
  receivers = np.sort(rng.integers(0, 40, 1000)).astype(np.int32)
  topo = gnn.EdgeTopology('e', 'a', 'b', senders, receivers).with_agg_plans(
      50, 40, min_max_degree=2)
  assert topo.sender_plan is not None and topo.recv_plan is not None
  net = gnn.InteractionNetwork(
      topologies=[topo], node_sizes={'a': 8, 'b': 8}, edge_sizes={'e': 8},
      num_nodes={'a': 50, 'b': 40}, mlp_hidden_size=8,
      mlp_num_hidden_layers=1, activation=torch.nn.functional.silu,
      f32_aggregation=True, aggregate_normalization=None,
      rng=torch.Generator().manual_seed(0))
  assert torch.equal(net.e_send_row_ptr,
                     torch.as_tensor(topo.sender_plan.row_ptr))
  assert torch.equal(net.e_recv_row_ptr,
                     torch.as_tensor(topo.recv_plan.row_ptr))
