"""Typed graph networks over static topologies (dense path).

Counterpart of `gencast_tpu.nn.gnn`: node/edge sets are dicts of [N, B, C]
/ [E, B, C] tensors, topology (sender/receiver indices) is fixed numpy at
construction, and receiver aggregation is a sorted segment sum. Edge sides
with a skewed degree distribution carry an `AggPlan` and aggregate through
the planned sum (kernel B on the card); gathers over a planned side take
the planned sum as their backward. On the card every other side of
non-uniform degree carries a plan too and takes the same two paths: there
`index_add_`, and with it the backward of `index_select`, adds atomically
in an order that changes from run to run, where the reference is bitwise
reproducible. The streamed-edge path and GNN remat of the reference are
memory machinery for 0.25 degrees and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gencast_tpu_torch.graph import plans
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
          edge_sizes[topo.name], activation, rng=rng)

    self.node_mlps = nn.ModuleDict()
    for name, size in node_sizes.items():
      in_size = size + sum(
          edge_sizes[t.name] for t in topologies if t.receiver_set == name)
      self.node_mlps[name] = CondMLP(
          in_size, mlp_hidden_size, mlp_num_hidden_layers, size, activation,
          rng=rng)

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
              cond: torch.Tensor) -> Tuple[NodeFeats, EdgeFeats]:
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
               f32_aggregation: bool = False,
               aggregate_normalization: Optional[float] = None,
               rng: torch.Generator,
               use_kernels: bool = True):
    super().__init__()
    act = _activation(activation)
    self.node_embedders = nn.ModuleDict()
    if embed_nodes:
      for name, latent in node_latent_size.items():
        self.node_embedders[name] = CondMLP(
            node_input_sizes[name], mlp_hidden_size, mlp_num_hidden_layers,
            latent, act, rng=rng)
    self.edge_embedders = nn.ModuleDict()
    if embed_edges:
      for name, latent in edge_latent_size.items():
        self.edge_embedders[name] = CondMLP(
            edge_input_sizes[name], mlp_hidden_size, mlp_num_hidden_layers,
            latent, act, rng=rng)
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
            rng=rng,
            use_kernels=use_kernels)
        for _ in range(num_message_passing_steps))
    self.node_decoders = nn.ModuleDict()
    for name, out in (node_output_sizes or {}).items():
      self.node_decoders[name] = MLP(
          node_latent_size[name], mlp_hidden_size, mlp_num_hidden_layers,
          out, act, rng=rng)

  def forward(self, nodes: NodeFeats, edges: EdgeFeats, cond: torch.Tensor
              ) -> Tuple[NodeFeats, EdgeFeats]:
    nodes = {k: (self.node_embedders[k](v, cond)
                 if k in self.node_embedders else v)
             for k, v in nodes.items()}
    edges = {k: (self.edge_embedders[k](v, cond)
                 if k in self.edge_embedders else v)
             for k, v in edges.items()}
    for processor in self.processors:
      upd_nodes, upd_edges = processor(nodes, edges, cond)
      nodes = {k: nodes[k] + upd_nodes[k] for k in nodes}
      edges = {k: edges[k] + upd_edges[k] for k in edges}
    out_nodes = {k: (self.node_decoders[k](v)
                     if k in self.node_decoders else v)
                 for k, v in nodes.items()}
    return out_nodes, edges
