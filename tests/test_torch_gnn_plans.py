"""Every edge side of non-uniform degree carries an aggregation plan for the
card, whatever the reference's degree gate says about speed.

On a CUDA device `index_add_`, and with it the backward of `index_select`,
adds atomically in an order that changes from run to run; the reference is
bitwise reproducible there. So `nn.gnn.InteractionNetwork` gives each such
side a CSR plan (non-persistent buffers) and, where `segment.adds_atomically`
says so, takes `segment_sum_planned` / `gather_planned` in place of the plain
paths. The CPU path and the state dict do not change. Here, on CPU: the
sides of the nano and TINY graphs that now carry plans, the planned paths
against the JAX package's `sorted_segment_sum` and gather VJP on inputs made
from a numpy seed (1e-5 relative: float32 sums in another order), and the
dispatch with `adds_atomically` patched to say yes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.ops import segment as jax_segment
from gencast_tpu_torch import configs
from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.nn import gnn
from gencast_tpu_torch.ops import segment
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# max|port - jax| / max|jax|: float32 sums in another order.
RTOL = 1e-5
SPECS = {'tiny': configs.TINY, 'nano': configs.NANO}
# The sides of the GenCast graphs whose degree is not uniform: grid2mesh's
# receivers (mesh nodes) and senders (grid nodes), mesh2grid's senders (mesh
# nodes). mesh2grid's receivers are 3 per grid node: the dense path.
SIDES = ('g2m_recv', 'g2m_send', 'm2g_send')
LATENT = 8


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope='module', params=sorted(SPECS))
def network(request):
  """(spec, statics, an InteractionNetwork over both edge sets of its graph,
  built as the denoiser builds its topologies)."""
  spec = SPECS[request.param]
  statics = configs.build_statics(spec)
  num_nodes = {'grid': statics.num_grid_nodes, 'mesh': statics.num_mesh_nodes}
  topologies = [
      gnn.EdgeTopology('g2m', 'grid', 'mesh', statics.grid2mesh.senders,
                       statics.grid2mesh.receivers),
      gnn.EdgeTopology('m2g', 'mesh', 'grid', statics.mesh2grid.senders,
                       statics.mesh2grid.receivers)]
  assert not spec.use_agg_plans  # neither preset plans a side itself
  net = gnn.InteractionNetwork(
      topologies=topologies, node_sizes={'grid': LATENT, 'mesh': LATENT},
      edge_sizes={'g2m': LATENT, 'm2g': LATENT}, num_nodes=num_nodes,
      mlp_hidden_size=LATENT, mlp_num_hidden_layers=1,
      activation=torch.nn.functional.silu, f32_aggregation=True,
      aggregate_normalization=None, rng=torch.Generator().manual_seed(0))
  return spec, statics, net


def _side(statics, side):
  """(segment ids, number of segments) of one edge side."""
  edges = statics.grid2mesh if side.startswith('g2m') else statics.mesh2grid
  ids = edges.receivers if side.endswith('recv') else edges.senders
  mesh = side in ('g2m_recv', 'm2g_send')
  return ids, statics.num_mesh_nodes if mesh else statics.num_grid_nodes


def test_unplanned_sides_carry_plans(network):
  _, statics, net = network
  assert net._card_only == set(SIDES)
  for side in SIDES:
    ids, n = _side(statics, side)
    plan = plans.build_agg_plan(ids, n)
    assert torch.equal(getattr(net, f'{side}_row_ptr'),
                       torch.as_tensor(plan.row_ptr))
    perm = getattr(net, f'{side}_perm')
    assert (perm is None) == (plan.perm is None)
    if perm is not None:
      assert torch.equal(perm, torch.as_tensor(plan.perm))
  assert not hasattr(net, 'm2g_recv_row_ptr')  # uniform degree 3
  # Plans are not parameters and not in the state dict.
  assert not [k for k in net.state_dict() if 'row_ptr' in k or 'perm' in k]


@pytest.mark.parametrize('side', SIDES)
def test_planned_paths_match_jax(network, side):
  """The forward sum and the gather's backward over each newly planned side
  against the JAX package's (its unplanned path, which these presets run)."""
  _, statics, net = network
  ids, n = _side(statics, side)
  e = ids.shape[0]
  row_ptr, perm = getattr(net, f'{side}_row_ptr'), getattr(net, f'{side}_perm')
  rng = np.random.default_rng(11)
  data = rng.standard_normal((e, 2, LATENT)).astype(np.float32)
  nodes = rng.standard_normal((n, 2, LATENT)).astype(np.float32)
  g_nodes = rng.standard_normal((n, 2, LATENT)).astype(np.float32)
  if side.endswith('recv'):
    # The aggregation and its VJP (receivers are ascending).
    want, vjp = jax.vjp(lambda x: jax_segment.sorted_segment_sum(
        x, jnp.asarray(ids), n, f32_accumulate=True), jnp.asarray(data))
    (want_grad,) = vjp(jnp.asarray(g_nodes))
    x = torch.tensor(data, requires_grad=True)
    got = segment.segment_sum_planned(x, row_ptr, perm, f32_accumulate=True)
    got.backward(torch.as_tensor(g_nodes))
    assert _rel(got.detach().numpy(), np.asarray(want)) <= RTOL
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want_grad))
  # The gather over the side and its VJP, the sum of the cotangent rows.
  want, vjp = jax.vjp(lambda x: jax_segment.gather(x, jnp.asarray(ids)),
                      jnp.asarray(nodes))
  (want_grad,) = vjp(jnp.asarray(data))
  x = torch.tensor(nodes, requires_grad=True)
  got = segment.gather_planned(x, torch.as_tensor(ids, dtype=torch.long),
                               row_ptr, perm)
  got.backward(torch.as_tensor(data))
  np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
  assert _rel(x.grad.numpy(), np.asarray(want_grad)) <= RTOL


def _run(net, statics, seed=5):
  """One forward and backward of the network; returns (outputs, gradients of
  the inputs), all numpy."""
  g = torch.Generator().manual_seed(seed)
  nodes = {'grid': torch.randn(statics.num_grid_nodes, 1, LATENT, generator=g),
           'mesh': torch.randn(statics.num_mesh_nodes, 1, LATENT, generator=g)}
  edges = {'g2m': torch.randn(statics.grid2mesh.num_edges, 1, LATENT,
                              generator=g),
           'm2g': torch.randn(statics.mesh2grid.num_edges, 1, LATENT,
                              generator=g)}
  leaves = list(nodes.values()) + list(edges.values())
  for t in leaves:
    t.requires_grad_(True)
  new_nodes, new_edges = net(nodes, edges, torch.randn(1, 16, generator=g))
  outs = list(new_nodes.values()) + list(new_edges.values())
  sum((o * o).sum() for o in outs).backward()
  return ([o.detach().numpy() for o in outs], [t.grad.numpy() for t in leaves])


def test_atomic_paths_are_not_reached_where_a_plan_exists(network,
                                                          monkeypatch):
  """With the plain paths atomic (as on the card), every side that has a
  plan goes through it: `sorted_segment_sum` sees only the uniform side and
  `gather` only broadcasts; the results equal the CPU path's, which takes
  the plain paths on the same sides."""
  _, statics, net = network
  want = _run(net, statics)

  calls = {'sum': 0, 'gather': 0}
  plain_sum, plain_gather = segment.sorted_segment_sum, segment.gather

  def checked_sum(data, segment_ids, num_segments, **kwargs):
    assert kwargs.get('uniform_k') is not None, 'index_add_ on a planned side'
    calls['sum'] += 1
    return plain_sum(data, segment_ids, num_segments, **kwargs)

  def checked_gather(nodes, indices, uniform_k=None):
    assert uniform_k is not None, 'index_select on a planned side'
    calls['gather'] += 1
    return plain_gather(nodes, indices, uniform_k)

  monkeypatch.setattr(segment, 'adds_atomically', lambda x: True)
  monkeypatch.setattr(segment, 'sorted_segment_sum', checked_sum)
  monkeypatch.setattr(segment, 'gather', checked_gather)
  got = _run(net, statics)
  assert calls == {'sum': 1, 'gather': 1}  # mesh2grid's receivers alone
  for g, w in zip(got[0] + got[1], want[0] + want[1]):
    assert _rel(g, w) <= RTOL


def test_cpu_path_keeps_the_plain_sides(network, monkeypatch):
  """On a CPU tensor the sides planned for the card alone stay on the plain
  paths (the reference's choice); a side the topology planned does not."""
  _, statics, net = network
  planned = []
  gather_planned = segment.gather_planned
  monkeypatch.setattr(segment, 'gather_planned', lambda *a: (
      planned.append(1), gather_planned(*a))[1])
  _run(net, statics)
  assert not planned
  topo = net.topologies[0].with_agg_plans(
      statics.num_grid_nodes, statics.num_mesh_nodes, min_max_degree=2)
  assert topo.recv_plan is not None and topo.sender_plan is not None
  net2 = gnn.InteractionNetwork(
      topologies=[topo], node_sizes={'grid': LATENT, 'mesh': LATENT},
      edge_sizes={'g2m': LATENT}, num_nodes=net.num_nodes,
      mlp_hidden_size=LATENT, mlp_num_hidden_layers=1,
      activation=torch.nn.functional.silu, f32_aggregation=True,
      aggregate_normalization=None, rng=torch.Generator().manual_seed(0))
  assert net2._card_only == set()
  x = torch.zeros(statics.num_mesh_nodes, 1, LATENT)
  assert net2._plan(topo, 'recv', x) is not None
  assert net._plan(net.topologies[0], 'recv', x) is None
