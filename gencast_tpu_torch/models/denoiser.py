"""GenCast denoiser: grid2mesh GNN -> sparse mesh transformer ->
mesh2grid GNN.

Counterpart of `gencast_tpu.models.denoiser` (with the streamed-edge GNNs
and whole-GNN remat of the 0.25-degree configuration), with its deliberate
deviation kept: the mesh-node embedder takes only the 3 structural
features (the reference's always-zero "dummy data" channels contribute
nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch import utils
from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data.registry import TaskSpec
from gencast_tpu_torch.graph.compiler import GraphStatics
from gencast_tpu_torch.nn import remat
from gencast_tpu_torch.nn.gnn import EdgeTopology, NodeShard, TypedGraphNet
from gencast_tpu_torch.nn.mlp import FourierFeaturesMLP
from gencast_tpu_torch.nn.transformer import MeshTransformer, \
    TransformerConfig


@dataclasses.dataclass(frozen=True)
class NoiseEncoderConfig:
  apply_log_first: bool = True
  base_period: float = 16.0
  num_frequencies: int = 32
  output_sizes: tuple = (32, 16)


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
  """Architecture hyperparameters (mesh/grid structure lives in
  GraphStatics)."""
  latent_size: int = 512
  hidden_layers: int = 1
  grid2mesh_aggregate_normalization: Optional[float] = None
  noise_encoder: NoiseEncoderConfig = NoiseEncoderConfig()
  # Planned aggregation (graph.plans.AggPlan) for skewed edge sides.
  use_agg_plans: bool = False
  # Minimum segment max-degree for an edge side to get a plan.
  agg_plan_min_degree: int = 32
  # Streamed edges in the encoder and decoder GNNs (nn/gnn.py
  # _streaming_call): edges this many at a time; None keeps the dense path.
  edge_chunk_size: Optional[int] = None
  # Remat the encoder and decoder GNNs as whole units: their backward
  # recomputes them instead of keeping their [num_grid_nodes, latent]-sized
  # activations (at 0.25 degrees, a GB each).
  remat_gnns: bool = False
  # The mesh axis to shard the grid nodes over (the reference's sequence
  # parallelism): 'model', the port's model axis, or None. Under a model
  # axis of size > 1 (`parallel.tensor.shard_model`) each rank then keeps a
  # contiguous share of the grid's latitude rows; see
  # `DenoiserArchitecture.shard_nodes`. Without one it changes nothing.
  node_sharding_axis: Optional[str] = None


class DenoiserArchitecture(nn.Module):
  """Encode-process-decode over grid & mesh nodes on node-leading tensors:
  grid data [G, B, C_data] in, grid outputs [G, B, out] back."""

  def __init__(self, statics: GraphStatics, transformer: TransformerConfig,
               num_data_channels: int, node_output_size: int,
               config: DenoiserConfig, *, rng: torch.Generator,
               use_kernels: bool = True,
               dense_attention_mask: Optional[np.ndarray] = None):
    super().__init__()
    cfg = config
    latent = cfg.latent_size
    self.remat_gnns = cfg.remat_gnns
    if cfg.node_sharding_axis not in (None, 'model'):
      raise ValueError(f'node_sharding_axis must be None or \'model\' (the '
                       f'model axis), got {cfg.node_sharding_axis!r}')
    self.config = cfg
    self.num_lat = statics.grid_lat.shape[0]
    self.num_lon = statics.grid_lon.shape[0]
    # Set by shard_nodes: the model axis the grid nodes are sharded over,
    # this rank's rows [lo, hi) of them, and the names of the parameters
    # whose gradients are partial over the axis.
    self.node_axis = None
    self.node_rows = None
    self._partial_params: list = []
    # The autograd graph task whose end sums the partial gradients.
    self._sum_task = None
    if transformer.d_model != latent:
      raise ValueError(
          f'transformer d_model ({transformer.d_model}) must equal the GNN '
          f'latent size ({latent})')
    for name, array in (('grid_struct', statics.grid_node_features),
                        ('mesh_struct', statics.mesh_node_features),
                        ('g2m_edge_feats', statics.grid2mesh.features),
                        ('m2g_edge_feats', statics.mesh2grid.features)):
      self.register_buffer(name, torch.as_tensor(array), persistent=False)

    num_nodes = {'grid': statics.num_grid_nodes,
                 'mesh': statics.num_mesh_nodes}
    g2m_topo = EdgeTopology('g2m', 'grid', 'mesh',
                            statics.grid2mesh.senders,
                            statics.grid2mesh.receivers)
    m2g_topo = EdgeTopology('m2g', 'mesh', 'grid',
                            statics.mesh2grid.senders,
                            statics.mesh2grid.receivers)
    if cfg.use_agg_plans:
      g2m_topo = g2m_topo.with_agg_plans(
          statics.num_grid_nodes, statics.num_mesh_nodes,
          min_max_degree=cfg.agg_plan_min_degree)
      m2g_topo = m2g_topo.with_agg_plans(
          statics.num_mesh_nodes, statics.num_grid_nodes,
          min_max_degree=cfg.agg_plan_min_degree)

    self.grid2mesh = TypedGraphNet(
        topologies=[g2m_topo],
        num_nodes=num_nodes,
        node_input_sizes={'grid': 3 + num_data_channels, 'mesh': 3},
        edge_input_sizes={'g2m': 4},
        node_latent_size={'grid': latent, 'mesh': latent},
        edge_latent_size={'g2m': latent},
        mlp_hidden_size=latent,
        mlp_num_hidden_layers=cfg.hidden_layers,
        num_message_passing_steps=1,
        f32_aggregation=True,
        aggregate_normalization=cfg.grid2mesh_aggregate_normalization,
        edge_chunk_size=cfg.edge_chunk_size,
        rng=rng, use_kernels=use_kernels)

    # The backend takes the tile plan ('pallas') or the tri-block mask
    # ('triblock_pallas', 'triblock') from the statics, or the [N, N] mask
    # ('dense') from the caller.
    self.processor = MeshTransformer(
        transformer, tile_plan=statics.attention_tile_plan,
        mask=statics.attention_mask, dense_mask=dense_attention_mask,
        rng=rng, use_kernels=use_kernels)

    self.mesh2grid = TypedGraphNet(
        topologies=[m2g_topo],
        num_nodes=num_nodes,
        node_input_sizes={},
        edge_input_sizes={'m2g': 4},
        node_latent_size={'grid': latent, 'mesh': latent},
        edge_latent_size={'m2g': latent},
        mlp_hidden_size=latent,
        mlp_num_hidden_layers=cfg.hidden_layers,
        num_message_passing_steps=1,
        embed_nodes=False,
        node_output_sizes={'grid': node_output_size},
        f32_aggregation=False,
        edge_chunk_size=cfg.edge_chunk_size,
        rng=rng, use_kernels=use_kernels)

  def custom_shard(self, axis) -> list:
    """`parallel.tensor.shard_model`'s hook: with `node_sharding_axis`
    'model', keeps this rank's grid nodes over `axis` (shard_nodes) and
    returns the GNNs, whose MLPs stay whole; else does nothing."""
    if self.config.node_sharding_axis != 'model':
      return []
    self.shard_nodes(axis)
    return [self.grid2mesh, self.mesh2grid]

  def shard_nodes(self, axis) -> None:
    """Keeps this rank's share of the grid nodes over `axis` (a
    `parallel.tensor.ModelAxis` of size > 1): whole latitude rows [lo, hi)
    (`tensor.node_rows`). The grid-node embedder, MLPs and decoder then run
    on those rows only; the grid2mesh edges whose sender is one of them
    (their mesh-side sums partial, summed by one float32 all_reduce before
    the mesh-node MLP) and the mesh2grid edges whose receiver is (their
    senders, mesh nodes, are on every rank: no halo). The mesh, and so the
    processor, stays whole. Aggregation plans (where the config asks for
    them) and stream chunks are built over the rank's edges. The GNNs'
    parameters stay whole on every rank; their gradients from this rank's
    rows are summed over the axis at the end of the backward pass."""
    from gencast_tpu_torch.parallel import tensor
    lo, hi = tensor.node_rows(self.num_lat, self.num_lon, axis)
    cfg = self.config
    shard = NodeShard(axis, frozenset({'grid'}))
    num_nodes = {'grid': hi - lo,
                 'mesh': self.grid2mesh.num_nodes['mesh']}
    for net, feats in ((self.grid2mesh, 'g2m_edge_feats'),
                       (self.mesh2grid, 'm2g_edge_feats')):
      (topo,) = net.topologies
      rank_topo, ids = rank_topology(topo, lo, hi, num_nodes['mesh'], cfg)
      net.shard_nodes(shard, [rank_topo], num_nodes)
      buf = getattr(self, feats)
      setattr(self, feats, buf[torch.as_tensor(ids, device=buf.device)])
    self.grid_struct = self.grid_struct[lo:hi].clone()
    partial = {id(m) for net in (self.grid2mesh, self.mesh2grid)
               for m in net.node_partial_modules()}
    self._partial_params = [
        f'{prefix}.{name}' for prefix, m in self.named_modules()
        if id(m) in partial for name, _ in m.named_parameters()]
    self.node_axis = axis
    self.node_rows = (lo, hi)

  def _queue_gradient_sum(self) -> None:
    """Queues, once per backward pass (autograd graph task), the sum over
    the node axis of the partial gradients that the pass adds
    (`tensor.sum_gradients`) for when the pass ends, so that the
    parameters' .grad hold the unsharded model's gradients. Called before
    the pass adds any: what .grad holds then (an earlier pass's gradients,
    accumulated) is kept out of the sum. A pass that raises before its end
    sums nothing and leaves the next pass to queue its own sum."""
    task = torch._C._current_graph_task_id()
    if task == self._sum_task:
      return
    self._sum_task = task
    params = dict(self.named_parameters())
    params = [params[n] for n in self._partial_params]
    before = [None if p.grad is None else p.grad.detach().clone()
              for p in params]

    def run():
      from gencast_tpu_torch.parallel import tensor
      tensor.sum_gradients(params, self.node_axis, before)

    torch.autograd.Variable._execution_engine.queue_callback(run)

  def forward(self, grid_data: torch.Tensor,
              cond: torch.Tensor) -> torch.Tensor:
    """grid_data: [G, B, C_data]; cond: [B, 16] -> [G, B, out]."""
    from gencast_tpu_torch.parallel import tensor
    num_grid = grid_data.shape[0]
    if self.node_axis is not None:
      grid_data = tensor.scatter_rows(grid_data, self.node_rows,
                                      self.node_axis)
    batch = grid_data.shape[1]
    dtype = grid_data.dtype

    def bcast(feat):
      return feat[:, None, :].to(dtype).expand(feat.shape[0], batch,
                                               feat.shape[1])

    grid_in = torch.cat([bcast(self.grid_struct), grid_data], dim=-1)

    def run_g2m(grid_in, mesh_in, edge_in, cond):
      nodes, _ = self.grid2mesh({'grid': grid_in, 'mesh': mesh_in},
                                {'g2m': edge_in}, cond)
      return nodes['grid'], nodes['mesh']

    def run_m2g(latent_grid, latent_mesh, edge_in, cond):
      # Only the grid nodes are decoded: the mesh nodes' update is skipped.
      nodes, _ = self.mesh2grid({'grid': latent_grid, 'mesh': latent_mesh},
                                {'m2g': edge_in}, cond, outputs=('grid',))
      return nodes['grid']

    device = grid_data.device
    with utils.span('grid2mesh', device):
      g2m_args = (grid_in, bcast(self.mesh_struct),
                  bcast(self.g2m_edge_feats), cond)
      if self.remat_gnns and torch.is_grad_enabled():
        # Whole-GNN remat (the reference's jax.checkpoint of run_g2m and
        # run_m2g); the streamed path's per-chunk remat nests inside.
        latent_grid, latent_mesh = remat.checkpoint(self.grid2mesh, run_g2m,
                                                    *g2m_args)
      else:
        latent_grid, latent_mesh = run_g2m(*g2m_args)
    latent_grid, latent_mesh = utils.gradient_mark('grid2mesh', latent_grid,
                                                   latent_mesh)
    with utils.span('processor', device):
      latent_mesh = self.processor(latent_mesh, cond).to(dtype)
    latent_mesh = utils.gradient_mark('processor', latent_mesh)
    with utils.span('mesh2grid', device):
      m2g_args = (latent_grid, latent_mesh, bcast(self.m2g_edge_feats), cond)
      if self.remat_gnns and torch.is_grad_enabled():
        out = remat.checkpoint(self.mesh2grid, run_m2g, *m2g_args)
      else:
        out = run_m2g(*m2g_args)
    out = utils.gradient_mark('mesh2grid', out)
    if self.node_axis is None:
      return out
    return tensor.gather_rows(out, self.node_rows[0], num_grid,
                              self.node_axis, self._queue_gradient_sum)


def rank_edges(topo: EdgeTopology, lo: int, hi: int) -> np.ndarray:
  """[E] bool: the edges of `topo` that the rank of grid rows [lo, hi)
  computes: a grid2mesh edge by its sender, a mesh2grid edge by its
  receiver (the grid end)."""
  ids = topo.senders if topo.sender_set == 'grid' else topo.receivers
  return (ids >= lo) & (ids < hi)


def rank_topology(topo: EdgeTopology, lo: int, hi: int, num_mesh: int,
                  config: DenoiserConfig
                  ) -> Tuple[EdgeTopology, np.ndarray]:
  """The edges of `topo` (grid2mesh or mesh2grid) that the rank of grid
  rows [lo, hi) computes, as a topology of their own (grid ids counted from
  lo, receivers still ascending; aggregation plans built over them where
  `config` asks for plans), and their indices into `topo`'s edges."""
  ids = np.flatnonzero(rank_edges(topo, lo, hi))
  if topo.sender_set == 'grid':
    senders, receivers = topo.senders[ids] - lo, topo.receivers[ids]
    sizes = (hi - lo, num_mesh)
  else:
    senders, receivers = topo.senders[ids], topo.receivers[ids] - lo
    sizes = (num_mesh, hi - lo)
  local = EdgeTopology(topo.name, topo.sender_set, topo.receiver_set,
                       senders, receivers)
  if config.use_agg_plans:
    local = local.with_agg_plans(
        *sizes, min_max_degree=config.agg_plan_min_degree)
  return local, ids


class Denoiser(nn.Module):
  """Noise-conditioned denoiser over packed [B, lat, lon, C] tensors.

  Appends noisy targets to forcings channel-wise (static permutation),
  encodes the noise level into the FiLM conditioning vector, and runs the
  architecture.
  """

  def __init__(self, task: TaskSpec, statics: GraphStatics,
               transformer: TransformerConfig,
               config: DenoiserConfig = DenoiserConfig(), *,
               rng: torch.Generator, use_kernels: bool = True,
               dense_attention_mask: Optional[np.ndarray] = None):
    super().__init__()
    self.task = task
    self.num_lat = statics.grid_lat.shape[0]
    self.num_lon = statics.grid_lon.shape[0]
    self.input_layout = layout_lib.build_layout(
        task.input_variables, task.pressure_levels, task.num_input_frames)
    self.target_layout = layout_lib.build_layout(
        task.target_variables, task.pressure_levels, 1)
    self.forcing_layout = layout_lib.build_layout(
        task.forcing_variables, task.pressure_levels, 1)
    self.cond_layout, perm = layout_lib.merge_permutation(
        self.forcing_layout, self.target_layout)
    self.register_buffer('cond_perm', torch.as_tensor(perm, dtype=torch.long),
                         persistent=False)

    num_data_channels = (self.input_layout.num_channels
                         + self.cond_layout.num_channels)
    ne = config.noise_encoder
    self.noise_encoder = FourierFeaturesMLP(
        base_period=ne.base_period, num_frequencies=ne.num_frequencies,
        output_sizes=ne.output_sizes, apply_log_first=ne.apply_log_first,
        rng=rng)
    self.architecture = DenoiserArchitecture(
        statics, transformer, num_data_channels=num_data_channels,
        node_output_size=self.target_layout.num_channels, config=config,
        rng=rng, use_kernels=use_kernels,
        dense_attention_mask=dense_attention_mask)

  def forward(self,
              inputs: torch.Tensor,        # [B, lat, lon, C_in]
              noisy_targets: torch.Tensor,  # [B, lat, lon, C_tgt]
              noise_levels: torch.Tensor,   # [B]
              forcings: torch.Tensor,       # [B, lat, lon, C_frc]
              ) -> torch.Tensor:
    # Conditioning in the compute dtype: noise levels stay float32, but a
    # float32 cond would re-promote every FiLM-conditioned activation.
    cond = self.noise_encoder(noise_levels).to(inputs.dtype)  # [B, 16]
    conditioning = torch.cat([forcings, noisy_targets], dim=-1).index_select(
        -1, self.cond_perm)
    grid_data = torch.cat([inputs, conditioning], dim=-1)
    b = grid_data.shape[0]
    g = self.num_lat * self.num_lon
    # [B, lat, lon, C] -> [G, B, C]
    node_data = grid_data.reshape(b, g, -1).transpose(0, 1)
    out = self.architecture(node_data, cond)  # [G, B, out]
    return out.transpose(0, 1).reshape(b, self.num_lat, self.num_lon, -1)
