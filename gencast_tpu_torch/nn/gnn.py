"""Typed graph networks over static topologies.

Counterpart of `gencast_tpu.nn.gnn`: node/edge sets are dicts of [N, B, C]
/ [E, B, C] tensors, topology (sender/receiver indices) is fixed numpy at
construction, and receiver aggregation is a sorted segment sum. Edge sides
with a skewed degree distribution carry an `AggPlan` and aggregate through
the planned sum (kernel B on the card); gathers over a planned side take
the planned sum as their backward. On the card every other side of
non-uniform degree carries a plan too and takes the same two paths: there
`index_add_`, and with it the backward of `index_select`, adds atomically
in an order that changes from run to run, where the reference is bitwise
reproducible.

The MLPs are GenCast's LayerNorm+FiLM ones under a conditioning vector, or
with `use_norm_conditioning=False` (GraphCast) a LayerNorm with a learned
scale and bias and no conditioning. A deep processor can recompute its
steps in the backward pass (`remat_steps`, nested in groups of steps with
`remat_group`), as the reference's checkpoints of its steps.

Two paths, as the reference's: the dense one, and for single-step nets with
`edge_chunk_size` the streamed one (`TypedGraphNet._streaming_call`, the
0.25-degree memory machinery), which takes the edges a chunk at a time
through the edge MLP and the receiver sum, each chunk recomputed in the
backward, so no [E, B, latent] tensor exists; node MLPs over more rows than
a chunk run chunk by chunk too. Each chunk carries its own plans, built
once in numpy, so the streamed path is as free of atomics on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.nn import remat
from gencast_tpu_torch.nn.mlp import MLP, CondMLP
from gencast_tpu_torch.ops import segment


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeTopology:
  """Static structure of one directed edge set, receivers ascending, with
  optional aggregation plans for its receiver and sender sides."""
  name: str
  sender_set: str
  receiver_set: str
  senders: np.ndarray
  receivers: np.ndarray
  recv_plan: Optional[plans.AggPlan] = None
  sender_plan: Optional[plans.AggPlan] = None

  @property
  def num_edges(self) -> int:
    return self.senders.shape[0]

  def with_agg_plans(self, num_sender_nodes: int, num_receiver_nodes: int,
                     min_max_degree: int = 32) -> 'EdgeTopology':
    """A copy carrying aggregation plans where the degree skew passes
    `plans.plan_if_profitable`; uniform / near-uniform sides keep the dense
    or plain paths."""
    return dataclasses.replace(
        self,
        recv_plan=plans.plan_if_profitable(
            self.receivers, num_receiver_nodes,
            min_max_degree=min_max_degree),
        sender_plan=plans.plan_if_profitable(
            self.senders, num_sender_nodes, min_max_degree=min_max_degree))


NodeFeats = Dict[str, torch.Tensor]   # set name -> [N, B, C]
EdgeFeats = Dict[str, torch.Tensor]   # edge set name -> [E, B, C]


def _activation(name: str) -> Callable:
  return {'swish': F.silu, 'identity': lambda x: x}[name]


class InteractionNetwork(nn.Module):
  """One message-passing step: edge update then node update.

  Edge update: MLP(concat[edge, sender_nodes[s], receiver_nodes[r]]).
  Node update: MLP(concat[node, aggregated incoming messages per edge set]).
  """

  def __init__(self, *,
               topologies: List[EdgeTopology],
               node_sizes: Mapping[str, int],
               edge_sizes: Mapping[str, int],
               num_nodes: Mapping[str, int],
               mlp_hidden_size: int,
               mlp_num_hidden_layers: int,
               activation: Callable,
               f32_aggregation: bool,
               aggregate_normalization: Optional[float],
               rng: torch.Generator,
               use_layer_norm: bool = True,
               use_norm_conditioning: bool = True,
               use_kernels: bool = True):
    super().__init__()
    self.topologies = topologies
    self.num_nodes = dict(num_nodes)
    self.f32_aggregation = f32_aggregation
    self.aggregate_normalization = aggregate_normalization
    self.use_kernels = use_kernels

    # Index and plan tensors as non-persistent buffers: they follow the
    # module's device but are not parameters and not in the state dict.
    # `_card_only` names the sides ('<edge set>_recv', '<edge set>_send')
    # whose plan the topology does not carry: it is used on the card alone,
    # where the unplanned paths are atomic (see `_plan`).
    self._uniform = {}
    self._card_only = set()
    for topo in topologies:
      self._uniform[topo.name] = (
          plans.uniform_degree(topo.senders, num_nodes[topo.sender_set]),
          plans.uniform_degree(topo.receivers, num_nodes[topo.receiver_set]))
      self._buffer(f'{topo.name}_senders', topo.senders, torch.long)
      self._buffer(f'{topo.name}_receivers', topo.receivers, torch.long)
      for side, plan, ids, node_set, uniform_k in (
          ('recv', topo.recv_plan, topo.receivers, topo.receiver_set,
           self._uniform[topo.name][1]),
          ('send', topo.sender_plan, topo.senders, topo.sender_set,
           self._uniform[topo.name][0])):
        if uniform_k is not None:
          continue  # the dense reshape-sum and the broadcast
        if plan is None:
          plan = plans.build_agg_plan(ids, num_nodes[node_set])
          self._card_only.add(f'{topo.name}_{side}')
        self._buffer(f'{topo.name}_{side}_row_ptr', plan.row_ptr, torch.int32)
        self._buffer(f'{topo.name}_{side}_perm', plan.perm, torch.int32)

    self.edge_mlps = nn.ModuleDict()
    for topo in topologies:
      in_size = (edge_sizes[topo.name] + node_sizes[topo.sender_set]
                 + node_sizes[topo.receiver_set])
      self.edge_mlps[topo.name] = CondMLP(
          in_size, mlp_hidden_size, mlp_num_hidden_layers,
          edge_sizes[topo.name], activation, rng=rng,
          use_layer_norm=use_layer_norm,
          use_norm_conditioning=use_norm_conditioning)

    self.node_mlps = nn.ModuleDict()
    for name, size in node_sizes.items():
      in_size = size + sum(
          edge_sizes[t.name] for t in topologies if t.receiver_set == name)
      self.node_mlps[name] = CondMLP(
          in_size, mlp_hidden_size, mlp_num_hidden_layers, size, activation,
          rng=rng, use_layer_norm=use_layer_norm,
          use_norm_conditioning=use_norm_conditioning)

  def _buffer(self, name: str, array: Optional[np.ndarray], dtype) -> None:
    tensor = None if array is None else torch.as_tensor(array, dtype=dtype)
    self.register_buffer(name, tensor, persistent=False)

  def _plan(self, topo: EdgeTopology, side: str, x: torch.Tensor
            ) -> Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """(row_ptr, perm) of the plan that `x`, gathered or summed over side
    `side` ('recv' or 'send') of `topo`, goes through; None for the dense
    or plain path. A side of uniform degree has no plan; a side that the
    topology planned (the reference's choice) always takes its plan; any
    other side takes one where the plain path would add atomically."""
    key = f'{topo.name}_{side}'
    if not hasattr(self, f'{key}_row_ptr'):
      return None
    if key in self._card_only and not segment.adds_atomically(x):
      return None
    return getattr(self, f'{key}_row_ptr'), getattr(self, f'{key}_perm')

  def _gather(self, x: torch.Tensor, topo: EdgeTopology, side: str,
              uniform_k: Optional[int]) -> torch.Tensor:
    indices = getattr(self, f'{topo.name}_{side}')
    plan = self._plan(topo, 'send' if side == 'senders' else 'recv', x)
    if plan is not None:
      return segment.gather_planned(x, indices, *plan)
    return segment.gather(x, indices, uniform_k)

  def forward(self, nodes: NodeFeats, edges: EdgeFeats,
              cond: Optional[torch.Tensor] = None
              ) -> Tuple[NodeFeats, EdgeFeats]:
    new_edges = {}
    for topo in self.topologies:
      send_k, recv_k = self._uniform[topo.name]
      sent = self._gather(nodes[topo.sender_set], topo, 'senders', send_k)
      received = self._gather(nodes[topo.receiver_set], topo, 'receivers',
                              recv_k)
      concat = torch.cat([edges[topo.name], sent, received], dim=-1)
      new_edges[topo.name] = self.edge_mlps[topo.name](concat, cond)

    new_nodes = {}
    for name, mlp in self.node_mlps.items():
      parts = [nodes[name]]
      for topo in self.topologies:
        if topo.receiver_set != name:
          continue
        messages = new_edges[topo.name]
        plan = self._plan(topo, 'recv', messages)
        if plan is not None:
          # B reads bf16 and sums in float32; f32_aggregation keeps the sum
          # in float32 through the normalization (else it is rounded to the
          # messages' dtype first, as the reference's kernel writes it).
          parts.append(segment.segment_sum_planned(
              messages, *plan, f32_accumulate=self.f32_aggregation,
              normalization=self.aggregate_normalization,
              use_kernel=self.use_kernels))
        else:
          parts.append(segment.sorted_segment_sum(
              messages,
              getattr(self, f'{topo.name}_receivers'),
              num_segments=self.num_nodes[name],
              f32_accumulate=self.f32_aggregation,
              normalization=self.aggregate_normalization,
              uniform_k=self._uniform[topo.name][1]))
      new_nodes[name] = mlp(torch.cat(parts, dim=-1), cond)
    return new_nodes, new_edges


class TypedGraphNet(nn.Module):
  """Encode-process-decode deep GNN over a static typed graph.

  Embedder MLPs lift raw node/edge features to latents, unshared
  InteractionNetwork steps run with node+edge residual connections, and
  decoder MLPs (plain, no norm) project listed node sets to outputs.
  """

  def __init__(self, *,
               topologies: List[EdgeTopology],
               num_nodes: Mapping[str, int],
               node_input_sizes: Mapping[str, int],
               edge_input_sizes: Mapping[str, int],
               node_latent_size: Mapping[str, int],
               edge_latent_size: Mapping[str, int],
               mlp_hidden_size: int,
               mlp_num_hidden_layers: int = 1,
               num_message_passing_steps: int = 1,
               embed_nodes: bool = True,
               embed_edges: bool = True,
               node_output_sizes: Optional[Mapping[str, int]] = None,
               activation: str = 'swish',
               use_layer_norm: bool = True,
               use_norm_conditioning: bool = True,
               f32_aggregation: bool = False,
               aggregate_normalization: Optional[float] = None,
               edge_chunk_size: Optional[int] = None,
               remat_steps: bool = False,
               remat_group: int = 1,
               rng: torch.Generator,
               use_kernels: bool = True):
    super().__init__()
    act = _activation(activation)
    norm = dict(use_layer_norm=use_layer_norm,
                use_norm_conditioning=use_norm_conditioning)
    # Recompute each processor step in the backward pass (the dense path;
    # the streamed one recomputes per chunk), and with remat_group > 1 nest
    # those checkpoints in checkpoints of groups of steps: the forward then
    # keeps num_steps / group + group step boundaries instead of num_steps,
    # for one more forward of each step in the backward.
    self.remat_steps = remat_steps
    self.remat_group = remat_group
    self.topologies = topologies
    self.num_nodes = dict(num_nodes)
    self.f32_aggregation = f32_aggregation
    self.aggregate_normalization = aggregate_normalization
    self.use_kernels = use_kernels
    self.edge_latent_size = dict(edge_latent_size)
    # Streamed edges (the reference's edge_chunk_size): valid only for a
    # single-step net whose caller does not read the output edge latents
    # (the encoder and decoder of the denoiser); see _streaming_call.
    self.edge_chunk_size = edge_chunk_size
    self.streams = nn.ModuleDict()
    if edge_chunk_size is not None:
      if num_message_passing_steps != 1:
        raise ValueError('edge_chunk_size requires a single-step graph net')
      for topo in topologies:
        self.streams[topo.name] = EdgeStream(topo, num_nodes,
                                             edge_chunk_size)
    self.node_embedders = nn.ModuleDict()
    if embed_nodes:
      for name, latent in node_latent_size.items():
        self.node_embedders[name] = CondMLP(
            node_input_sizes[name], mlp_hidden_size, mlp_num_hidden_layers,
            latent, act, rng=rng, **norm)
    self.edge_embedders = nn.ModuleDict()
    if embed_edges:
      for name, latent in edge_latent_size.items():
        self.edge_embedders[name] = CondMLP(
            edge_input_sizes[name], mlp_hidden_size, mlp_num_hidden_layers,
            latent, act, rng=rng, **norm)
    self.processors = nn.ModuleList(
        InteractionNetwork(
            topologies=topologies,
            node_sizes=node_latent_size,
            edge_sizes=edge_latent_size,
            num_nodes=num_nodes,
            mlp_hidden_size=mlp_hidden_size,
            mlp_num_hidden_layers=mlp_num_hidden_layers,
            activation=act,
            f32_aggregation=f32_aggregation,
            aggregate_normalization=aggregate_normalization,
            rng=rng, use_kernels=use_kernels, **norm)
        for _ in range(num_message_passing_steps))
    self.node_decoders = nn.ModuleDict()
    for name, out in (node_output_sizes or {}).items():
      self.node_decoders[name] = MLP(
          node_latent_size[name], mlp_hidden_size, mlp_num_hidden_layers,
          out, act, rng=rng)

  def forward(self, nodes: NodeFeats, edges: EdgeFeats,
              cond: Optional[torch.Tensor] = None
              ) -> Tuple[NodeFeats, EdgeFeats]:
    if self.edge_chunk_size is not None:
      return self._streaming_call(nodes, edges, cond)
    nodes = {k: (self.node_embedders[k](v, cond)
                 if k in self.node_embedders else v)
             for k, v in nodes.items()}
    edges = {k: (self.edge_embedders[k](v, cond)
                 if k in self.edge_embedders else v)
             for k, v in edges.items()}
    remat_on = self.remat_steps and torch.is_grad_enabled()
    group = self.remat_group if remat_on else 1
    for lo in range(0, len(self.processors), group):
      steps = list(self.processors[lo:lo + group])
      if group > 1:
        nodes, edges = self._checkpointed(
            nn.ModuleList(steps), self._run_steps(steps, remat_on),
            nodes, edges, cond)
      else:
        nodes, edges = self._run_steps(steps, remat_on)(nodes, edges, cond)
    out_nodes = {k: (self.node_decoders[k](v)
                     if k in self.node_decoders else v)
                 for k, v in nodes.items()}
    return out_nodes, edges

  def _run_steps(self, steps: List['InteractionNetwork'], remat_on: bool
                 ) -> Callable:
    """fn(nodes, edges, cond) running `steps` with their residuals, each
    step recomputed in the backward pass when remat_on."""

    def step(p, nodes, edges, cond):
      upd_nodes, upd_edges = p(nodes, edges, cond)
      return ({k: nodes[k] + upd_nodes[k] for k in nodes},
              {k: edges[k] + upd_edges[k] for k in edges})

    def run(nodes, edges, cond):
      for p in steps:
        if remat_on:
          nodes, edges = self._checkpointed(
              p, lambda n, e, c, p=p: step(p, n, e, c), nodes, edges, cond)
        else:
          nodes, edges = step(p, nodes, edges, cond)
      return nodes, edges
    return run

  @staticmethod
  def _checkpointed(module: nn.Module, fn: Callable, nodes: NodeFeats,
                    edges: EdgeFeats, cond: Optional[torch.Tensor]
                    ) -> Tuple[NodeFeats, EdgeFeats]:
    """fn(nodes, edges, cond) -> (nodes, edges), recomputed in the backward
    pass with the parameters of `module` this call saw (nn/remat.py): the
    reference's jax.checkpoint of a step or group of steps."""
    n_keys, e_keys = list(nodes), list(edges)
    args = [nodes[k] for k in n_keys] + [edges[k] for k in e_keys]
    if cond is not None:
      args.append(cond)

    def flat(*xs):
      c = xs[len(n_keys) + len(e_keys)] if cond is not None else None
      out_n, out_e = fn(dict(zip(n_keys, xs[:len(n_keys)])),
                        dict(zip(e_keys, xs[len(n_keys):])), c)
      return tuple(out_n[k] for k in n_keys) + tuple(out_e[k]
                                                     for k in e_keys)

    out = remat.checkpoint(module, flat, *args)
    return (dict(zip(n_keys, out[:len(n_keys)])),
            dict(zip(e_keys, out[len(n_keys):])))

  # --- The streamed path ---

  def _remat(self, fn: Callable, *args) -> torch.Tensor:
    """fn(*args), recomputed in the backward pass when gradients are on (the
    reference's jax.checkpoint of a scan body): only the inputs are kept,
    and the parameters are bound again in the recomputation (nn/remat.py)."""
    if torch.is_grad_enabled():
      return remat.checkpoint(self, fn, *args)
    return fn(*args)

  def _node_chunked(self, fn: Callable, arrays: List[torch.Tensor]
                    ) -> torch.Tensor:
    """fn over leading-axis chunks of `arrays` when they have more rows than
    a chunk (the reference's _chunked_node_apply): chunks of equal size when
    they divide the rows, else of edge_chunk_size and a shorter last one;
    each recomputed in the backward. The chunks are views from one split, so
    the backward writes each input's gradient once, not one [N, ...] tensor
    per chunk."""
    n = arrays[0].shape[0]
    chunk = self.edge_chunk_size
    if n <= chunk:
      return fn(*arrays)
    n_chunks = -(-n // chunk)
    if n % n_chunks == 0:
      chunk = n // n_chunks
    pieces = [a.split(chunk) for a in arrays]
    return torch.cat([self._remat(fn, *xs) for xs in zip(*pieces)])

  def _streaming_call(self, nodes: NodeFeats, edges: EdgeFeats,
                      cond: Optional[torch.Tensor]
                      ) -> Tuple[NodeFeats, EdgeFeats]:
    """The single-step forward with the edges taken a chunk at a time
    (the reference's _streaming_call). The same numbers as the dense path
    but for summation order across chunks, and the output edges are the
    raw input edges (no edge latents are made)."""
    node_lat = {}
    for k, v in nodes.items():
      if k in self.node_embedders:
        emb = self.node_embedders[k]
        node_lat[k] = self._node_chunked(
            lambda v_c, emb=emb: emb(v_c, cond), [v])
      else:
        node_lat[k] = v
    processor = self.processors[0]
    agg = {topo.name: self._stream_edges(topo, processor, edges[topo.name],
                                         node_lat, cond)
           for topo in self.topologies}

    out_nodes = {}
    for name, mlp in processor.node_mlps.items():
      aggs = [agg[t.name] for t in self.topologies if t.receiver_set == name]
      decoder = (self.node_decoders[name] if name in self.node_decoders
                 else None)

      def update(lat_c, *agg_c, mlp=mlp, decoder=decoder):
        out = lat_c + mlp(torch.cat([lat_c, *agg_c], dim=-1), cond)
        return decoder(out) if decoder is not None else out

      out_nodes[name] = self._node_chunked(update, [node_lat[name], *aggs])
    return out_nodes, edges

  def _stream_edges(self, topo: EdgeTopology,
                    processor: InteractionNetwork, raw_e: torch.Tensor,
                    node_lat: NodeFeats, cond: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """The receiver aggregation [N_recv, B, latent] (in the edges' dtype) of
    `topo`'s edge-MLP messages, edges a chunk at a time."""
    stream = self.streams[topo.name]
    embed = (self.edge_embedders[topo.name]
             if topo.name in self.edge_embedders else None)
    edge_mlp = processor.edge_mlps[topo.name]
    norm = self.aggregate_normalization
    sender_lat = node_lat[topo.sender_set]
    receiver_lat = node_lat[topo.receiver_set]
    plan_send = stream.takes_plan(topo.sender_plan, sender_lat)
    raw_chunks = raw_e.split(stream.chunk)

    def message(c, raw_c, senders, received):
      e_lat = embed(raw_c, cond) if embed is not None else raw_c
      sent = stream.gather(senders, c, 'send', plan_send)
      return edge_mlp(torch.cat([e_lat, sent, received], dim=-1), cond)

    if stream.uniform_k is not None:
      # Uniform receiver degree (mesh2grid's 3 senders per grid node): each
      # chunk holds whole receivers, whose latents are a row slice broadcast
      # edge-wise and whose sums are a dense reshape-sum finished inside the
      # chunk: no accumulator, no scatter, the dense path's sums.
      k = stream.uniform_k

      def body_u(c, raw_c, senders, rows):
        msg = message(c, raw_c, senders, segment.gather(rows, None, k))
        return segment.sorted_segment_sum(
            msg, None, rows.shape[0], f32_accumulate=self.f32_aggregation,
            normalization=norm, uniform_k=k)

      rows = receiver_lat.split(stream.chunk // k)
      return torch.cat([
          self._remat(lambda *a, c=c: body_u(c, *a), raw_c, sender_lat,
                      rows[c])
          for c, raw_c in enumerate(raw_chunks)])

    # Any other degree: each chunk's messages are summed per receiver over
    # the chunk (kernel B over the chunk's plan, or index_add_ on the CPU)
    # and the sum added into the receivers' rows of an accumulator, chunk
    # after chunk: a receiver whose edges straddle chunks gets its parts in
    # chunk order.
    plan_recv = stream.takes_plan(topo.recv_plan, receiver_lat)
    acc_dtype = torch.float32 if self.f32_aggregation else raw_e.dtype
    acc = raw_e.new_zeros(
        (self.num_nodes[topo.receiver_set],) + raw_e.shape[1:-1]
        + (self.edge_latent_size[topo.name],), dtype=acc_dtype)

    def body(c, raw_c, senders, receivers):
      msg = message(c, raw_c, senders,
                    stream.gather(receivers, c, 'recv', plan_recv))
      if plan_recv:
        return segment.segment_sum_planned(
            msg, *stream.plan(c, 'recv'), f32_accumulate=True,
            use_kernel=self.use_kernels, out_dtype=acc_dtype)
      lo, hi = stream.rows(c, 'recv')
      return segment.sorted_segment_sum(
          msg.to(acc_dtype), stream.local_ids(c, 'recv'), hi - lo)

    for c, raw_c in enumerate(raw_chunks):
      lo, hi = stream.rows(c, 'recv')
      acc[lo:hi] += self._remat(lambda *a, c=c: body(c, *a), raw_c,
                                sender_lat, receiver_lat)
    if norm is not None:
      acc = acc / norm
    return acc.to(raw_e.dtype)


class EdgeStream(nn.Module):
  """The chunks of one edge set for the streamed path, built once in numpy
  (the reference's stream_meta and stream_indices).

  Chunks are consecutive runs of `chunk` edges (receiver order), the last
  one shorter; where the receiver degree is a uniform k (and k <= the
  requested chunk) the chunk is cut down to a multiple of k, so each chunk
  holds whole receivers. On each side (but the receivers of a uniform
  degree) each chunk spans a range of nodes [lo, hi) and carries, as
  non-persistent buffers, its edges' node ids within that range and the
  CSR plan of those ids (graph.plans): the gather over the side reads the
  range and its backward is the planned sum, and a receiver sum is the
  planned sum, so neither direction scatters on the card.
  """

  def __init__(self, topo: EdgeTopology, num_nodes: Mapping[str, int],
               edge_chunk_size: int):
    super().__init__()
    e = topo.num_edges
    k = plans.uniform_degree(topo.receivers, num_nodes[topo.receiver_set])
    chunk = edge_chunk_size
    if k is not None and chunk >= k:
      chunk -= chunk % k
    else:
      k = None
    self.chunk = chunk
    self.uniform_k = k
    self.num_chunks = -(-e // chunk)
    self._rows = {}
    sides = [('send', topo.senders)]
    if k is None:
      sides.append(('recv', topo.receivers))
    for side, ids in sides:
      for c in range(self.num_chunks):
        chunk_ids = np.asarray(ids[c * chunk:(c + 1) * chunk], np.int64)
        lo, hi = int(chunk_ids.min()), int(chunk_ids.max()) + 1
        self._rows[(c, side)] = (lo, hi)
        plan = plans.build_agg_plan(chunk_ids - lo, hi - lo)
        self._buffer(f'{side}{c}_ids', chunk_ids - lo, torch.long)
        self._buffer(f'{side}{c}_row_ptr', plan.row_ptr, torch.int32)
        self._buffer(f'{side}{c}_perm', plan.perm, torch.int32)

  def _buffer(self, name: str, array: Optional[np.ndarray], dtype) -> None:
    tensor = None if array is None else torch.as_tensor(array, dtype=dtype)
    self.register_buffer(name, tensor, persistent=False)

  def rows(self, c: int, side: str) -> Tuple[int, int]:
    """[lo, hi): the node range chunk `c` reaches on `side`."""
    return self._rows[(c, side)]

  def local_ids(self, c: int, side: str) -> torch.Tensor:
    """Chunk `c`'s node ids on `side`, less the range's start."""
    return getattr(self, f'{side}{c}_ids')

  def plan(self, c: int, side: str
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(row_ptr, perm) of chunk `c`'s plan on `side`, over its range."""
    return (getattr(self, f'{side}{c}_row_ptr'),
            getattr(self, f'{side}{c}_perm'))

  @staticmethod
  def takes_plan(topo_plan: Optional[plans.AggPlan], x: torch.Tensor) -> bool:
    """Whether a side goes through the chunks' plans for a tensor like `x`:
    where the topology planned the side (the reference's choice) or where
    the plain path would add atomically (the card)."""
    return topo_plan is not None or segment.adds_atomically(x)

  def gather(self, nodes: torch.Tensor, c: int, side: str,
             planned: bool) -> torch.Tensor:
    """nodes[ids of chunk c on `side`], read from the chunk's node range:
    with `planned` through `gather_planned` (its backward the planned sum
    over the range), else index_select."""
    lo, hi = self.rows(c, side)
    if planned:
      return segment.gather_planned(nodes[lo:hi], self.local_ids(c, side),
                                    *self.plan(c, side))
    return segment.gather(nodes[lo:hi], self.local_ids(c, side))
