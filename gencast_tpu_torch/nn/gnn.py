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

A caller names the node sets it reads (`outputs`); the last step updates
only those. Under a node axis (`NodeShard`, set by `shard_nodes`) a
single-step net holds one rank's rows of its local node sets and the edges
that touch them, with plans and chunks over those edges; its sums into a
set whole on every rank are partial, finished by one float32 all_reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.nn import remat
from gencast_tpu_torch.nn.mlp import MLP, CondMLP
from gencast_tpu_torch.ops import segment
from gencast_tpu_torch.parallel import tensor


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
    self.f32_aggregation = f32_aggregation
    self.aggregate_normalization = aggregate_normalization
    self.use_kernels = use_kernels
    self._topology_buffers = []
    self.set_topologies(topologies, num_nodes)

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

  def set_topologies(self, topologies: List[EdgeTopology],
                     num_nodes: Mapping[str, int],
                     device: Optional[torch.device] = None) -> None:
    """Takes `topologies` over `num_nodes` (at construction; again for a
    rank's share of a node axis): their index and plan tensors as
    non-persistent buffers on `device`, which follow the module's device
    but are not parameters and not in the state dict. `_card_only` names
    the sides ('<edge set>_recv', '<edge set>_send') whose plan the
    topology does not carry: it is used on the card alone, where the
    unplanned paths are atomic (see `_plan`)."""
    for name in self._topology_buffers:
      delattr(self, name)
    self._topology_buffers = []
    self.topologies = topologies
    self.num_nodes = dict(num_nodes)
    self._uniform = {}
    self._card_only = set()
    for topo in topologies:
      self._uniform[topo.name] = (
          plans.uniform_degree(topo.senders, num_nodes[topo.sender_set]),
          plans.uniform_degree(topo.receivers, num_nodes[topo.receiver_set]))
      self._buffer(f'{topo.name}_senders', topo.senders, torch.long, device)
      self._buffer(f'{topo.name}_receivers', topo.receivers, torch.long,
                   device)
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
        self._buffer(f'{topo.name}_{side}_row_ptr', plan.row_ptr, torch.int32,
                     device)
        self._buffer(f'{topo.name}_{side}_perm', plan.perm, torch.int32,
                     device)

  def _buffer(self, name: str, array: Optional[np.ndarray], dtype,
              device=None) -> None:
    tensor = None if array is None else torch.as_tensor(array, dtype=dtype,
                                                        device=device)
    self.register_buffer(name, tensor, persistent=False)
    self._topology_buffers.append(name)

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
              cond: Optional[torch.Tensor] = None,
              outputs: Optional[Sequence[str]] = None,
              shard: Optional['_ShardCall'] = None
              ) -> Tuple[NodeFeats, EdgeFeats]:
    """The updated edges and the updated node sets `outputs` (default:
    every set). Under a node axis (`shard`), edges and the local node sets
    hold this rank's rows."""
    shard = shard or _ShardCall(None, cond)
    inputs = {}
    new_edges = {}
    for topo in self.topologies:
      send_k, recv_k = self._uniform[topo.name]
      sent = self._gather(shard.edge_input(nodes, topo.sender_set, inputs),
                          topo, 'senders', send_k)
      received = self._gather(
          shard.edge_input(nodes, topo.receiver_set, inputs), topo,
          'receivers', recv_k)
      concat = torch.cat([edges[topo.name], sent, received], dim=-1)
      new_edges[topo.name] = self.edge_mlps[topo.name](
          concat, shard.cond_of(None, cond))

    new_nodes = {}
    for name, mlp in self.node_mlps.items():
      if outputs is not None and name not in outputs:
        continue  # nothing reads it: not computed
      parts = [nodes[name]]
      for topo in self.topologies:
        if topo.receiver_set == name:
          parts.append(self._aggregate(new_edges[topo.name], topo, shard))
      new_nodes[name] = mlp(torch.cat(parts, dim=-1),
                            shard.cond_of(name, cond))
    return new_nodes, new_edges

  def _aggregate(self, messages: torch.Tensor, topo: EdgeTopology,
                 shard: '_ShardCall') -> torch.Tensor:
    """The receivers' sums of `topo`'s messages; under a node axis, into a
    set whole on every rank, this rank's partial sums in float32 summed
    over the axis (`_ShardCall.finish`)."""
    name = topo.receiver_set
    plan = self._plan(topo, 'recv', messages)
    if shard.partial(name):
      if plan is not None:
        part = segment.segment_sum_planned(
            messages, *plan, f32_accumulate=True,
            use_kernel=self.use_kernels, out_dtype=torch.float32)
      else:
        part = segment.sorted_segment_sum(
            messages.float(), getattr(self, f'{topo.name}_receivers'),
            num_segments=self.num_nodes[name],
            uniform_k=self._uniform[topo.name][1])
      return shard.finish(part, self.f32_aggregation,
                          self.aggregate_normalization, messages.dtype)
    if plan is not None:
      # B reads bf16 and sums in float32; f32_aggregation keeps the sum in
      # float32 through the normalization (else it is rounded to the
      # messages' dtype first, as the reference's kernel writes it).
      return segment.segment_sum_planned(
          messages, *plan, f32_accumulate=self.f32_aggregation,
          normalization=self.aggregate_normalization,
          use_kernel=self.use_kernels)
    return segment.sorted_segment_sum(
        messages, getattr(self, f'{topo.name}_receivers'),
        num_segments=self.num_nodes[name],
        f32_accumulate=self.f32_aggregation,
        normalization=self.aggregate_normalization,
        uniform_k=self._uniform[topo.name][1])


@dataclasses.dataclass(frozen=True, eq=False)
class NodeShard:
  """A GNN's share of a node axis (`DenoiserConfig.node_sharding_axis`):
  the node sets in `local` hold this rank's rows of the axis `axis` (a
  `parallel.tensor.ModelAxis`), every other set is whole on every rank,
  and every edge is this rank's (it touches a local row)."""
  axis: object
  local: frozenset


class _ShardCall:
  """One forward's view of a `NodeShard` (none: every set whole). Whole
  sets that local edges read, and the conditioning that local rows take,
  go through `parallel.tensor.copy_in` once (the gradient from this rank's
  rows summed over the axis backward); a sum into a whole set is a partial
  sum, finished by one float32 all_reduce."""

  def __init__(self, shard: Optional[NodeShard], cond):
    self.shard = shard
    self.local_cond = cond
    if shard is not None and cond is not None:
      self.local_cond = tensor.copy_in(cond, shard.axis)

  def is_local(self, name: Optional[str]) -> bool:
    """Whether node set `name` (None: the edges) holds this rank's rows."""
    return self.shard is not None and (name is None
                                       or name in self.shard.local)

  def cond_of(self, name: Optional[str], cond):
    """The conditioning of the MLPs over set `name` (None: the edges)."""
    return self.local_cond if self.is_local(name) else cond

  def partial(self, name: str) -> bool:
    """Whether the edges' sums into set `name` are partial on this rank."""
    return self.shard is not None and name not in self.shard.local

  def edge_input(self, nodes: NodeFeats, name: str, seen: dict
                 ) -> torch.Tensor:
    """nodes[name] as this rank's edges read it (`seen` keeps one copy per
    set)."""
    if self.shard is None or name in self.shard.local:
      return nodes[name]
    if name not in seen:
      seen[name] = tensor.copy_in(nodes[name], self.shard.axis)
    return seen[name]

  def finish(self, part: torch.Tensor, f32_aggregation: bool,
             normalization: Optional[float], dtype) -> torch.Tensor:
    """The full sums from this rank's float32 partial sums `part`, then as
    the unsharded aggregation: rounded to `dtype` first unless
    `f32_aggregation`, normalized, cast to `dtype`."""
    total = tensor.reduce_sum(part, self.shard.axis)
    if not f32_aggregation:
      total = total.to(dtype)
    if normalization is not None:
      total = total / normalization
    return total.to(dtype)


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
    if edge_chunk_size is not None and num_message_passing_steps != 1:
      raise ValueError('edge_chunk_size requires a single-step graph net')
    self.streams = nn.ModuleDict()
    self._set_streams()
    # A rank's share of a node axis (`shard_nodes`); None: every node set
    # whole.
    self.node_shard: Optional[NodeShard] = None
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
              cond: Optional[torch.Tensor] = None,
              outputs: Optional[Sequence[str]] = None
              ) -> Tuple[NodeFeats, EdgeFeats]:
    """The output node sets (decoded where a decoder is given) and edges.
    `outputs` names the node sets the caller reads: the last step updates
    only those, and only those are returned (default: every set)."""
    shard = _ShardCall(self.node_shard, cond)
    if self.edge_chunk_size is not None:
      return self._streaming_call(nodes, edges, cond, shard, outputs)
    nodes = {k: (self.node_embedders[k](v, shard.cond_of(k, cond))
                 if k in self.node_embedders else v)
             for k, v in nodes.items()}
    edges = {k: (self.edge_embedders[k](v, shard.cond_of(None, cond))
                 if k in self.edge_embedders else v)
             for k, v in edges.items()}
    remat_on = self.remat_steps and torch.is_grad_enabled()
    group = self.remat_group if remat_on else 1
    for lo in range(0, len(self.processors), group):
      steps = list(self.processors[lo:lo + group])
      last = outputs if lo + group >= len(self.processors) else None
      run = self._run_steps(steps, remat_on, shard, last)
      if group > 1:
        nodes, edges = self._checkpointed(nn.ModuleList(steps), run, nodes,
                                          edges, cond, last)
      else:
        nodes, edges = run(nodes, edges, cond)
    out_nodes = {k: (self.node_decoders[k](v)
                     if k in self.node_decoders else v)
                 for k, v in nodes.items()}
    return out_nodes, edges

  def _run_steps(self, steps: List['InteractionNetwork'], remat_on: bool,
                 shard: '_ShardCall', outputs: Optional[Sequence[str]]
                 ) -> Callable:
    """fn(nodes, edges, cond) running `steps` with their residuals, each
    step recomputed in the backward pass when remat_on; the last step
    updates and returns only the node sets `outputs` (None: every set)."""

    def step(p, nodes, edges, cond, outputs):
      upd_nodes, upd_edges = p(nodes, edges, cond, outputs, shard)
      return ({k: nodes[k] + upd_nodes[k] for k in upd_nodes},
              {k: edges[k] + upd_edges[k] for k in edges})

    def run(nodes, edges, cond):
      for i, p in enumerate(steps):
        out = outputs if i + 1 == len(steps) else None
        if remat_on:
          nodes, edges = self._checkpointed(
              p, lambda n, e, c, p=p, out=out: step(p, n, e, c, out),
              nodes, edges, cond, out)
        else:
          nodes, edges = step(p, nodes, edges, cond, out)
      return nodes, edges
    return run

  @staticmethod
  def _checkpointed(module: nn.Module, fn: Callable, nodes: NodeFeats,
                    edges: EdgeFeats, cond: Optional[torch.Tensor],
                    outputs: Optional[Sequence[str]] = None
                    ) -> Tuple[NodeFeats, EdgeFeats]:
    """fn(nodes, edges, cond) -> (nodes, edges), recomputed in the backward
    pass with the parameters of `module` this call saw (nn/remat.py): the
    reference's jax.checkpoint of a step or group of steps. fn returns the
    node sets `outputs` (None: those it was given)."""
    n_keys, e_keys = list(nodes), list(edges)
    out_keys = [k for k in n_keys if outputs is None or k in outputs]
    args = [nodes[k] for k in n_keys] + [edges[k] for k in e_keys]
    if cond is not None:
      args.append(cond)

    def flat(*xs):
      c = xs[len(n_keys) + len(e_keys)] if cond is not None else None
      out_n, out_e = fn(dict(zip(n_keys, xs[:len(n_keys)])),
                        dict(zip(e_keys, xs[len(n_keys):])), c)
      return tuple(out_n[k] for k in out_keys) + tuple(out_e[k]
                                                       for k in e_keys)

    out = remat.checkpoint(module, flat, *args)
    return (dict(zip(out_keys, out[:len(out_keys)])),
            dict(zip(e_keys, out[len(out_keys):])))

  # --- Topologies: construction, and a rank's share of a node axis ---

  def _set_streams(self, device: Optional[torch.device] = None) -> None:
    """The streamed path's chunks (an EdgeStream per edge set) of the
    current topologies."""
    if self.edge_chunk_size is None:
      return
    for topo in self.topologies:
      self.streams[topo.name] = EdgeStream(topo, self.num_nodes,
                                           self.edge_chunk_size).to(device)

  def shard_nodes(self, shard: NodeShard, topologies: List[EdgeTopology],
                  num_nodes: Mapping[str, int]) -> None:
    """Takes this rank's share of a node axis: `topologies`, this rank's
    edges (node ids of the `shard.local` sets counted from the rank's
    first row; plans and stream chunks built over them here), over
    `num_nodes`. The parameters stay whole."""
    if len(self.processors) != 1 or self.remat_steps:
      raise ValueError('a node axis takes single-step graph nets without '
                       'step remat')
    device = next(self.parameters()).device
    self.topologies = topologies
    self.num_nodes = dict(num_nodes)
    self.processors[0].set_topologies(topologies, num_nodes, device)
    self._set_streams(device)
    self.node_shard = shard

  def node_partial_modules(self) -> List[nn.Module]:
    """Under a node axis, the modules that see only this rank's rows: their
    parameters' gradients are partial sums over the axis (the embedders
    and MLPs of the edges and of the local node sets, and the local
    decoders)."""
    if self.node_shard is None:
      return []
    local = self.node_shard.local
    inet = self.processors[0]
    return (list(self.edge_embedders.values())
            + list(inet.edge_mlps.values())
            + [m for k, m in self.node_embedders.items() if k in local]
            + [m for k, m in inet.node_mlps.items() if k in local]
            + [m for k, m in self.node_decoders.items() if k in local])

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
                      cond: Optional[torch.Tensor], shard: '_ShardCall',
                      outputs: Optional[Sequence[str]]
                      ) -> Tuple[NodeFeats, EdgeFeats]:
    """The single-step forward with the edges taken a chunk at a time
    (the reference's _streaming_call). The same numbers as the dense path
    but for summation order across chunks, and the output edges are the
    raw input edges (no edge latents are made)."""
    node_lat = {}
    for k, v in nodes.items():
      if k in self.node_embedders:
        emb, c = self.node_embedders[k], shard.cond_of(k, cond)
        node_lat[k] = self._node_chunked(
            lambda v_c, emb=emb, c=c: emb(v_c, c), [v])
      else:
        node_lat[k] = v
    processor = self.processors[0]
    inputs = {}
    agg = {topo.name: self._stream_edges(
        topo, processor, edges[topo.name],
        shard.edge_input(node_lat, topo.sender_set, inputs),
        shard.edge_input(node_lat, topo.receiver_set, inputs),
        shard.cond_of(None, cond), shard) for topo in self.topologies}

    out_nodes = {}
    for name, mlp in processor.node_mlps.items():
      if outputs is not None and name not in outputs:
        continue  # nothing reads it: not computed
      aggs = [agg[t.name] for t in self.topologies if t.receiver_set == name]
      decoder = (self.node_decoders[name] if name in self.node_decoders
                 else None)

      def update(lat_c, *agg_c, mlp=mlp, decoder=decoder,
                 c=shard.cond_of(name, cond)):
        out = lat_c + mlp(torch.cat([lat_c, *agg_c], dim=-1), c)
        return decoder(out) if decoder is not None else out

      out_nodes[name] = self._node_chunked(update, [node_lat[name], *aggs])
    return out_nodes, edges

  def _stream_edges(self, topo: EdgeTopology,
                    processor: InteractionNetwork, raw_e: torch.Tensor,
                    sender_lat: torch.Tensor, receiver_lat: torch.Tensor,
                    cond: Optional[torch.Tensor], shard: '_ShardCall'
                    ) -> torch.Tensor:
    """The receiver aggregation [N_recv, B, latent] (in the edges' dtype) of
    `topo`'s edge-MLP messages, edges a chunk at a time; under a node axis
    into a whole set, this rank's partial sums summed over the axis."""
    stream = self.streams[topo.name]
    embed = (self.edge_embedders[topo.name]
             if topo.name in self.edge_embedders else None)
    edge_mlp = processor.edge_mlps[topo.name]
    norm = self.aggregate_normalization
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
    partial = shard.partial(topo.receiver_set)
    acc_dtype = (torch.float32 if self.f32_aggregation or partial
                 else raw_e.dtype)
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
    if partial:
      return shard.finish(acc, self.f32_aggregation, norm, raw_e.dtype)
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
