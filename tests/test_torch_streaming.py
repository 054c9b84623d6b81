"""The port's streamed-edge GNN path against the JAX package's, on CPU.

`nn.gnn.TypedGraphNet` with `edge_chunk_size` takes the edges a chunk at a
time through the edge MLP and the receiver sum, as the reference's
`_streaming_call`. Here, on the small graphs of the reference's own
streaming tests (`tests/test_streaming_gnn.py`), with the same chunks (37,
which divides no edge count, and 64), inputs from a numpy seed and the same
perturbed weights on both sides: the grid2mesh-style net (receivers of
non-uniform degree), the mesh2grid-style net (3 senders per receiver, the
chunk cut to 36), outputs and parameter gradients, each held to the JAX
streamed net and to the port's dense path. Then the card's dispatch on the
CPU: with `segment.adds_atomically` patched to say yes, every side of
non-uniform degree goes through the chunks' plans (no index_add_ and no
index_select under autograd), with the plain streamed path's numbers.
"""

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.nn import gnn as jax_gnn
from gencast_tpu_torch import bridge
from gencast_tpu_torch.graph import compiler
from gencast_tpu_torch.nn import gnn
from gencast_tpu_torch.ops import segment
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Outputs, max|port - jax| <= TOL + TOL * |jax| (the reference's streaming
# tests' own bound): float32 on both sides, sums in other orders.
TOL = 2e-5
# Parameter gradients, the same form, as the reference's gradient tests.
GRAD_TOL = 3e-5
# The card's planned dispatch against the plain streamed path, max
# |planned - plain| / max|plain|: the same float32 sums, per chunk in CSR
# order instead of index_add_'s.
DISPATCH_RTOL = 1e-6
LATENT = 16


def _statics(step_deg):
  lat = np.arange(-90.0, 90.1, step_deg, dtype=np.float32)
  lon = np.arange(0.0, 360.0, step_deg, dtype=np.float32)
  return (jax_compiler.build_graph_statics(1, lat, lon,
                                           build_attention_mask=False),
          compiler.build_graph_statics(1, lat, lon))


def _kwargs(kind, statics):
  """The net of the reference's streaming tests: 'g2m' (grid -> mesh,
  aggregate normalization 2, mesh decoded) or 'm2g' (mesh -> grid, grid
  decoded)."""
  es = statics.grid2mesh if kind == 'g2m' else statics.mesh2grid
  senders, receivers = (('grid', 'mesh') if kind == 'g2m'
                        else ('mesh', 'grid'))
  kw = dict(
      num_nodes={'grid': statics.num_grid_nodes,
                 'mesh': statics.num_mesh_nodes},
      node_input_sizes={'grid': 5, 'mesh': 3},
      edge_input_sizes={kind: 4},
      node_latent_size={'grid': LATENT, 'mesh': LATENT},
      edge_latent_size={kind: LATENT},
      mlp_hidden_size=LATENT, mlp_num_hidden_layers=1,
      num_message_passing_steps=1, f32_aggregation=True,
      node_output_sizes={receivers: 6})
  if kind == 'g2m':
    kw['aggregate_normalization'] = 2.0
  return kw, (kind, senders, receivers, es.senders, es.receivers)


def _pair(kind, chunk, step_deg, seed=0):
  """(JAX streamed net, port streamed net, port dense net, port statics)
  holding the same perturbed weights."""
  jstatics, statics = _statics(step_deg)
  kw, topo = _kwargs(kind, jstatics)
  jnet = jax_gnn.TypedGraphNet(topologies=[jax_gnn.EdgeTopology(*topo)],
                               edge_chunk_size=chunk, rngs=nnx.Rngs(seed),
                               **kw)
  flat_state = nnx.to_flat_state(nnx.state(jnet, nnx.Param))
  flat = bridge.perturbed({'/'.join(map(str, p)): np.asarray(v.get_value())
                           for p, v in flat_state}, seed=seed + 1)
  nnx.update(jnet, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in flat_state]))
  kw, topo = _kwargs(kind, statics)
  nets = []
  for c in (chunk, None):
    net = gnn.TypedGraphNet(topologies=[gnn.EdgeTopology(*topo)],
                            edge_chunk_size=c,
                            rng=torch.Generator().manual_seed(seed), **kw)
    bridge.load_reference_params(net, flat)
    nets.append(net)
  return jnet, nets[0], nets[1], statics


def _inputs(kind, statics, batch, seed, zero_cond=False):
  rng = np.random.default_rng(seed)
  es = statics.grid2mesh if kind == 'g2m' else statics.mesh2grid
  arrays = {
      'grid': rng.standard_normal((statics.num_grid_nodes, batch, 5)),
      'mesh': rng.standard_normal((statics.num_mesh_nodes, batch, 3)),
      'edges': rng.standard_normal((es.num_edges, batch, 4)),
      'cond': (np.zeros((batch, 16)) if zero_cond
               else rng.standard_normal((batch, 16)))}
  return {k: v.astype(np.float32) for k, v in arrays.items()}


def _run_jax(net, kind, x):
  out, _ = net({'grid': jnp.asarray(x['grid']),
                'mesh': jnp.asarray(x['mesh'])},
               {kind: jnp.asarray(x['edges'])}, jnp.asarray(x['cond']))
  return {k: np.asarray(v) for k, v in out.items()}


def _run_port(net, kind, x):
  with torch.no_grad():
    out, _ = net({'grid': torch.as_tensor(x['grid']),
                  'mesh': torch.as_tensor(x['mesh'])},
                 {kind: torch.as_tensor(x['edges'])},
                 torch.as_tensor(x['cond']))
  return {k: v.numpy() for k, v in out.items()}


def _loss_port(net, kind, x):
  out, _ = net({'grid': torch.as_tensor(x['grid']),
                'mesh': torch.as_tensor(x['mesh'])},
               {kind: torch.as_tensor(x['edges'])}, torch.as_tensor(x['cond']))
  return sum((v ** 2).mean() for v in out.values())


def _grads_port(net, kind, x):
  net.zero_grad()
  _loss_port(net, kind, x).backward()
  return bridge.export_reference_grads(net)


def _grads_jax(net, kind, x):
  def loss(m):
    out, _ = m({'grid': jnp.asarray(x['grid']),
                'mesh': jnp.asarray(x['mesh'])},
               {kind: jnp.asarray(x['edges'])}, jnp.asarray(x['cond']))
    return sum((v ** 2).mean() for v in out.values())
  grads = nnx.grad(loss)(net)
  return {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in nnx.to_flat_state(grads)}


def _assert_close(got, want, tol, what):
  assert got.keys() == want.keys(), what
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                               err_msg=f'{what}: {k}')


@pytest.mark.parametrize('kind,chunk,step_deg,batch,seed', [
    # The reference's test_streaming_matches_dense: a chunk that divides no
    # edge count.
    ('g2m', 37, 30.0, 2, 1),
    # Its test_streaming_uniform_degree_matches_dense: 37 is cut to 36.
    ('m2g', 37, 30.0, 2, 3),
])
def test_streamed_outputs_match_jax(kind, chunk, step_deg, batch, seed):
  jnet, net, dense, statics = _pair(kind, chunk, step_deg)
  x = _inputs(kind, statics, batch, seed)
  want = _run_jax(jnet, kind, x)
  _assert_close(_run_port(net, kind, x), want, TOL, 'port streamed vs jax')
  _assert_close(_run_port(dense, kind, x), want, TOL, 'port dense vs jax')
  _assert_close(_run_port(net, kind, x), _run_port(dense, kind, x), TOL,
                'port streamed vs port dense')


@pytest.mark.parametrize('kind,chunk,step_deg,batch,seed,zero_cond', [
    # The reference's test_streaming_gradients_match.
    ('g2m', 64, 45.0, 1, 2, True),
    # Its uniform-degree test's gradients.
    ('m2g', 37, 30.0, 2, 3, False),
])
def test_streamed_gradients_match_jax(kind, chunk, step_deg, batch, seed,
                                      zero_cond):
  jnet, net, dense, statics = _pair(kind, chunk, step_deg)
  x = _inputs(kind, statics, batch, seed, zero_cond)
  want = _grads_jax(jnet, kind, x)
  got = _grads_port(net, kind, x)
  _assert_close(got, want, GRAD_TOL, 'port streamed vs jax')
  _assert_close(_grads_port(dense, kind, x), want, GRAD_TOL,
                'port dense vs jax')
  # The edge embedder and edge MLP take gradients from every chunk.
  assert any(np.abs(v).max() > 0 for k, v in got.items() if 'edge' in k)


def test_stream_chunks_follow_the_reference():
  """The chunks of the reference's stream_meta: the requested size, cut to
  a multiple of a uniform receiver degree (whole receivers per chunk), the
  last chunk shorter; each side's node range covers its chunk's ids."""
  jstatics, statics = _statics(30.0)
  for kind, chunk in (('g2m', 37), ('m2g', 37)):
    kw, topo = _kwargs(kind, statics)
    net = gnn.TypedGraphNet(topologies=[gnn.EdgeTopology(*topo)],
                            edge_chunk_size=chunk,
                            rng=torch.Generator().manual_seed(0), **kw)
    jkw, jtopo = _kwargs(kind, jstatics)
    jnet = jax_gnn.TypedGraphNet(topologies=[jax_gnn.EdgeTopology(*jtopo)],
                                 edge_chunk_size=chunk, rngs=nnx.Rngs(0),
                                 **jkw)
    stream = net.streams[kind]
    assert (stream.chunk, stream.uniform_k) == jnet.stream_meta[kind]
    senders, receivers = topo[3], topo[4]
    assert stream.num_chunks == -(-len(senders) // stream.chunk)
    sides = [('send', senders)]
    if stream.uniform_k is None:
      sides.append(('recv', receivers))
    for c in range(stream.num_chunks):
      for side, ids in sides:
        lo, hi = stream.rows(c, side)
        part = ids[c * stream.chunk:(c + 1) * stream.chunk]
        np.testing.assert_array_equal(
            stream.local_ids(c, side).numpy() + lo, part)
        assert (lo, hi) == (part.min(), part.max() + 1)
  assert net.streams['m2g'].chunk == 36


def test_streaming_needs_a_single_step_net():
  _, statics = _statics(30.0)
  kw, topo = _kwargs('g2m', statics)
  kw['num_message_passing_steps'] = 2
  with pytest.raises(ValueError, match='single-step'):
    gnn.TypedGraphNet(topologies=[gnn.EdgeTopology(*topo)],
                      edge_chunk_size=37,
                      rng=torch.Generator().manual_seed(0), **kw)


@pytest.mark.parametrize('kind', ['g2m', 'm2g'])
def test_card_dispatch_takes_the_chunk_plans(kind, monkeypatch):
  """With the plain paths atomic (as on the card), each chunk's gathers and
  receiver sum over a side of non-uniform degree go through its plans:
  `sorted_segment_sum` and `gather` see only mesh2grid's uniform receivers
  (a reshape-sum and a broadcast), never index_add_ or index_select. The
  outputs and gradients equal the plain streamed path's."""
  _, net, _, statics = _pair(kind, 37, 30.0)
  x = _inputs(kind, statics, 2, 5)
  want = _run_port(net, kind, x)
  want_grads = _grads_port(net, kind, x)

  calls = {'sum': 0, 'gather': 0, 'planned_sum': 0, 'planned_gather': 0}
  plain_sum, plain_gather = segment.sorted_segment_sum, segment.gather
  planned_sum, planned_gather = (segment.segment_sum_planned,
                                 segment.gather_planned)

  def checked_sum(data, segment_ids, num_segments, **kwargs):
    assert kwargs.get('uniform_k') is not None, 'index_add_ on a chunk'
    calls['sum'] += 1
    return plain_sum(data, segment_ids, num_segments, **kwargs)

  def checked_gather(nodes, indices, uniform_k=None):
    assert uniform_k is not None, 'index_select on a chunk'
    calls['gather'] += 1
    return plain_gather(nodes, indices, uniform_k)

  def counted(name, fn):
    def wrapped(*args, **kwargs):
      calls[name] += 1
      return fn(*args, **kwargs)
    return wrapped

  monkeypatch.setattr(segment, 'adds_atomically', lambda t: True)
  monkeypatch.setattr(segment, 'sorted_segment_sum', checked_sum)
  monkeypatch.setattr(segment, 'gather', checked_gather)
  monkeypatch.setattr(segment, 'segment_sum_planned',
                      counted('planned_sum', planned_sum))
  monkeypatch.setattr(segment, 'gather_planned',
                      counted('planned_gather', planned_gather))
  got = _run_port(net, kind, x)
  chunks = net.streams[kind].num_chunks
  if kind == 'g2m':
    # Per chunk: the sender and receiver gathers and the receiver sum.
    assert calls == {'sum': 0, 'gather': 0, 'planned_sum': chunks,
                     'planned_gather': 2 * chunks}
  else:
    # Per chunk: the sender gather; the receivers are whole in a chunk.
    assert calls == {'sum': chunks, 'gather': chunks, 'planned_sum': 0,
                     'planned_gather': chunks}
  got_grads = _grads_port(net, kind, x)
  for k in want:
    assert (np.abs(got[k] - want[k]).max()
            <= DISPATCH_RTOL * np.abs(want[k]).max()), k
  for k in want_grads:
    scale = np.abs(want_grads[k]).max()
    assert np.abs(got_grads[k] - want_grads[k]).max() <= DISPATCH_RTOL * max(
        scale, 1e-30), k
