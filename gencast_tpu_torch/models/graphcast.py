"""GraphCast: deterministic encode-process-decode forecasting.

Counterpart of `gencast_tpu.models.graphcast`. It shares the GNN stack with
GenCast's denoiser; the processor is a deep multimesh GNN (`gnn_msg_steps`
unshared InteractionNetwork steps over the edges of every mesh refinement
level) instead of a transformer, and there is no noise conditioning: its
MLPs end in a LayerNorm with a learned scale and bias, never LN+FiLM, so
kernel E is not on its path. On the card every edge side of non-uniform
degree aggregates through kernel B (the grid2mesh receivers and the
multimesh's in the forward, every planned gather's backward).

On the card an undifferentiated `predict` replays one CUDA graph of the
forward per (shapes, dtype, device) of its inputs: the port's counterpart
of the reference's jitted `predict_rollout`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data.registry import TaskSpec
from gencast_tpu_torch.graph import features as features_lib
from gencast_tpu_torch.graph.compiler import GraphStatics
from gencast_tpu_torch.nn import remat
from gencast_tpu_torch.nn.gnn import EdgeTopology, TypedGraphNet
from gencast_tpu_torch.ops import cuda_lib, losses
from gencast_tpu_torch.parallel import tensor


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
  """The reference's GraphCastConfig."""
  latent_size: int = 512
  gnn_msg_steps: int = 16
  hidden_layers: int = 1
  radius_query_fraction_edge_length: float = 0.6
  mesh2grid_edge_normalization_factor: Optional[float] = None
  # Streamed edges in the grid2mesh / mesh2grid GNNs (nn/gnn.py).
  edge_chunk_size: Optional[int] = None
  # Planned aggregation for skewed edge sides, and its degree gate (the
  # reference's choice; on the card every side of non-uniform degree is
  # planned anyway).
  use_agg_plans: bool = False
  agg_plan_min_degree: int = 32
  # Recompute in the backward pass: the encoder and decoder as whole GNNs
  # and each processor step, nested in groups of `remat_group` steps.
  remat: bool = False
  remat_group: int = 1


# Loss weight per surface variable; atmospheric variables weigh 1.0 (the
# reference's GraphCast LOSS_WEIGHTS_SURFACE).
LOSS_WEIGHTS_SURFACE = {
    '2m_temperature': 1.0,
    '10m_u_component_of_wind': 0.1,
    '10m_v_component_of_wind': 0.1,
    'mean_sea_level_pressure': 0.1,
    'total_precipitation_6hr': 0.1,
}


def m2g_edge_rescale(statics: GraphStatics, factor: float) -> float:
  """The factor that turns the statics' mesh2grid edge features (length and
  relative position over the longest edge) into the same over `factor`:
  the reference's exact rescale for mesh2grid_edge_normalization_factor.
  The receiver-local rotation keeps norms, so the longest edge needs only
  the endpoints' positions."""
  grid_lon, grid_lat = np.meshgrid(statics.grid_lon, statics.grid_lat)
  s_pos = features_lib.spherical_to_xyz(*features_lib.lat_lon_to_spherical(
      statics.mesh_lat, statics.mesh_lon))
  r_pos = features_lib.spherical_to_xyz(*features_lib.lat_lon_to_spherical(
      grid_lat.reshape(-1).astype(np.float32),
      grid_lon.reshape(-1).astype(np.float32)))
  max_len = float(np.linalg.norm(
      s_pos[statics.mesh2grid.senders]
      - r_pos[statics.mesh2grid.receivers], axis=-1).max())
  return max_len / factor


class GraphCast(nn.Module):
  """Deterministic predictor over packed [B, lat, lon, C] tensors."""

  @staticmethod
  def _plan(topo: EdgeTopology, num_senders: int, num_receivers: int,
            cfg: GraphCastConfig) -> EdgeTopology:
    if not cfg.use_agg_plans:
      return topo
    return topo.with_agg_plans(num_senders, num_receivers,
                               min_max_degree=cfg.agg_plan_min_degree)

  def __init__(self, task: TaskSpec, statics: GraphStatics,
               config: GraphCastConfig = GraphCastConfig(), *,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    if statics.multimesh_edges is None:
      raise ValueError('GraphCast requires GraphStatics built with '
                       'build_multimesh=True')
    self.task = task
    cfg = config
    self.config = cfg
    latent = cfg.latent_size
    self.num_lat = statics.grid_lat.shape[0]
    self.num_lon = statics.grid_lon.shape[0]
    self.input_layout = layout_lib.build_layout(
        task.input_variables, task.pressure_levels, task.num_input_frames)
    self.target_layout = layout_lib.build_layout(
        task.target_variables, task.pressure_levels, 1)
    self.forcing_layout = layout_lib.build_layout(
        task.forcing_variables, task.pressure_levels, 1)

    m2g_feats = statics.mesh2grid.features
    if cfg.mesh2grid_edge_normalization_factor is not None:
      m2g_feats = m2g_feats * np.float32(m2g_edge_rescale(
          statics, cfg.mesh2grid_edge_normalization_factor))
    for name, array in (
        ('grid_struct', statics.grid_node_features),
        ('mesh_struct', statics.mesh_node_features),
        ('g2m_edge_feats', statics.grid2mesh.features),
        ('mm_edge_feats', statics.multimesh_edges.features),
        ('m2g_edge_feats', m2g_feats)):
      self.register_buffer(name, torch.as_tensor(array), persistent=False)

    num_nodes = {'grid': statics.num_grid_nodes,
                 'mesh': statics.num_mesh_nodes}
    num_data = (self.input_layout.num_channels
                + self.forcing_layout.num_channels)
    common = dict(mlp_hidden_size=latent,
                  mlp_num_hidden_layers=cfg.hidden_layers,
                  activation='swish', use_layer_norm=True,
                  use_norm_conditioning=False, rng=rng,
                  use_kernels=use_kernels)

    self.grid2mesh = TypedGraphNet(
        topologies=[self._plan(
            EdgeTopology('g2m', 'grid', 'mesh', statics.grid2mesh.senders,
                         statics.grid2mesh.receivers),
            statics.num_grid_nodes, statics.num_mesh_nodes, cfg)],
        num_nodes=num_nodes,
        node_input_sizes={'grid': 3 + num_data, 'mesh': 3},
        edge_input_sizes={'g2m': 4},
        node_latent_size={'grid': latent, 'mesh': latent},
        edge_latent_size={'g2m': latent},
        num_message_passing_steps=1,
        f32_aggregation=True,
        edge_chunk_size=cfg.edge_chunk_size,
        **common)

    mm = statics.multimesh_edges
    self.mesh_gnn = TypedGraphNet(
        topologies=[self._plan(
            EdgeTopology('mesh', 'mesh', 'mesh', mm.senders, mm.receivers),
            statics.num_mesh_nodes, statics.num_mesh_nodes, cfg)],
        num_nodes={'mesh': statics.num_mesh_nodes},
        node_input_sizes={},
        edge_input_sizes={'mesh': 4},
        node_latent_size={'mesh': latent},
        edge_latent_size={'mesh': latent},
        num_message_passing_steps=cfg.gnn_msg_steps,
        embed_nodes=False,
        f32_aggregation=False,
        remat_steps=cfg.remat,
        remat_group=cfg.remat_group,
        **common)

    self.mesh2grid = TypedGraphNet(
        topologies=[self._plan(
            EdgeTopology('m2g', 'mesh', 'grid', statics.mesh2grid.senders,
                         statics.mesh2grid.receivers),
            statics.num_mesh_nodes, statics.num_grid_nodes, cfg)],
        num_nodes=num_nodes,
        node_input_sizes={},
        edge_input_sizes={'m2g': 4},
        node_latent_size={'grid': latent, 'mesh': latent},
        edge_latent_size={'m2g': latent},
        num_message_passing_steps=1,
        embed_nodes=False,
        node_output_sizes={'grid': self.target_layout.num_channels},
        f32_aggregation=False,
        edge_chunk_size=cfg.edge_chunk_size,
        **common)

    chan_w, diag_w = layout_lib.loss_channel_weights(self.target_layout,
                                                     LOSS_WEIGHTS_SURFACE)
    for name, array in (
        ('lat_weights', layout_lib.latitude_weights(statics.grid_lat)),
        ('loss_weights', chan_w), ('diag_weights', diag_w)):
      self.register_buffer(name, torch.as_tensor(array), persistent=False)
    # The graphs of `predict`, one per shapes and dtype of its inputs.
    self.predict_graphs = cuda_lib.GraphedCalls()

  def _apply(self, fn, recurse=True):
    # Moving the parameters (.to(), .cuda()) gives them new storage, which
    # the predict graphs would not see.
    self.predict_graphs = cuda_lib.GraphedCalls()
    return super()._apply(fn, recurse)

  def _forward(self, inputs: torch.Tensor,
               forcings: torch.Tensor) -> torch.Tensor:
    """One forward step: [B, lat, lon, C_in] -> [B, lat, lon, C_tgt]."""
    b = inputs.shape[0]
    dtype = inputs.dtype
    g = self.num_lat * self.num_lon
    grid_data = torch.cat([inputs, forcings], dim=-1)
    node_data = grid_data.reshape(b, g, -1).transpose(0, 1)

    def bcast(feat):
      return feat[:, None, :].to(dtype).expand(feat.shape[0], b,
                                               feat.shape[1])

    grid_in = torch.cat([bcast(self.grid_struct), node_data], dim=-1)

    def run_g2m(grid_in, mesh_in, edge_in):
      nodes, _ = self.grid2mesh({'grid': grid_in, 'mesh': mesh_in},
                                {'g2m': edge_in})
      return nodes['grid'], nodes['mesh']

    def run_m2g(latent_grid, latent_mesh, edge_in):
      nodes, _ = self.mesh2grid({'grid': latent_grid, 'mesh': latent_mesh},
                                {'m2g': edge_in})
      return nodes['grid']

    # Whole-GNN remat of the encoder and decoder (the reference's
    # jax.checkpoint of run_g2m and run_m2g); the processor's per-step
    # remat is the mesh GNN's own (remat_steps).
    whole = self.config.remat and torch.is_grad_enabled()
    g2m_args = (grid_in, bcast(self.mesh_struct), bcast(self.g2m_edge_feats))
    if whole:
      latent_grid, latent_mesh = remat.checkpoint(self.grid2mesh, run_g2m,
                                                  *g2m_args)
    else:
      latent_grid, latent_mesh = run_g2m(*g2m_args)
    nodes, _ = self.mesh_gnn({'mesh': latent_mesh},
                             {'mesh': bcast(self.mm_edge_feats)})
    m2g_args = (latent_grid, nodes['mesh'], bcast(self.m2g_edge_feats))
    if whole:
      out = remat.checkpoint(self.mesh2grid, run_m2g, *m2g_args)
    else:
      out = run_m2g(*m2g_args)  # [G, B, C_tgt]
    return out.transpose(0, 1).reshape(b, self.num_lat, self.num_lon, -1)

  def predict(self, inputs: torch.Tensor, forcings: torch.Tensor,
              generator: Optional[torch.Generator] = None, *,
              graphed: bool = True) -> torch.Tensor:
    """One forward step: [B, lat, lon, C_in] -> [B, lat, lon, C_tgt]
    (deterministic: `generator` is not drawn from). On the card, without
    gradients and with `graphed`, a replay of the model's CUDA graph of
    these shapes; eager for a model sharded over a model axis (its
    all_reduces are not captured, parallel/tensor.py)."""
    del generator
    if (graphed and inputs.is_cuda and not torch.is_grad_enabled()
        and not tensor.is_sharded(self)):
      graph = self.predict_graphs.get(
          cuda_lib.signature(inputs, forcings),
          lambda: (torch.empty_like(inputs), torch.empty_like(forcings)))
      graph.load(inputs, forcings)
      return graph(self._forward).clone()
    return self._forward(inputs, forcings)

  def forward(self, inputs, forcings):
    return self.predict(inputs, forcings)

  def loss_and_predictions(self, inputs: torch.Tensor,
                           targets: torch.Tensor, forcings: torch.Tensor,
                           generator: Optional[torch.Generator] = None):
    """((loss [B], per-variable diagnostics), predictions): the latitude-
    and level-weighted MSE of one forward step (never a graph replay)."""
    preds = self._forward(inputs, forcings)
    loss = losses.weighted_mse(preds, targets, self.lat_weights,
                               self.loss_weights)
    diags = losses.per_variable_diagnostics(
        preds, targets, self.lat_weights, self.target_layout,
        self.diag_weights)
    return (loss, diags), preds

  def loss(self, inputs: torch.Tensor, targets: torch.Tensor,
           forcings: torch.Tensor,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    (loss, diags), _ = self.loss_and_predictions(inputs, targets, forcings)
    return loss, diags
