"""GenCast denoiser: grid2mesh GNN -> block-sparse mesh transformer ->
mesh2grid GNN.

Counterpart of `gencast_tpu.models.denoiser`, with its deliberate deviation
kept: the mesh-node embedder takes only the 3 structural features (the
reference's always-zero "dummy data" channels contribute nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data.registry import TaskSpec
from gencast_tpu_torch.graph.compiler import GraphStatics
from gencast_tpu_torch.nn.gnn import EdgeTopology, TypedGraphNet
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


class DenoiserArchitecture(nn.Module):
  """Encode-process-decode over grid & mesh nodes on node-leading tensors:
  grid data [G, B, C_data] in, grid outputs [G, B, out] back."""

  def __init__(self, statics: GraphStatics, transformer: TransformerConfig,
               num_data_channels: int, node_output_size: int,
               config: DenoiserConfig, *, rng: torch.Generator,
               use_kernels: bool = True):
    super().__init__()
    cfg = config
    latent = cfg.latent_size
    if transformer.d_model != latent:
      raise ValueError(
          f'transformer d_model ({transformer.d_model}) must equal the GNN '
          f'latent size ({latent})')
    if statics.attention_tile_plan is None:
      raise ValueError('statics were built without an attention tile plan '
                       '(attention_tile_size=0)')

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
        rng=rng, use_kernels=use_kernels)

    self.processor = MeshTransformer(
        transformer, statics.attention_tile_plan, rng=rng,
        use_kernels=use_kernels)

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
        rng=rng, use_kernels=use_kernels)

  def forward(self, grid_data: torch.Tensor,
              cond: torch.Tensor) -> torch.Tensor:
    """grid_data: [G, B, C_data]; cond: [B, 16] -> [G, B, out]."""
    batch = grid_data.shape[1]
    dtype = grid_data.dtype

    def bcast(feat):
      return feat[:, None, :].to(dtype).expand(feat.shape[0], batch,
                                               feat.shape[1])

    grid_in = torch.cat([bcast(self.grid_struct), grid_data], dim=-1)
    nodes, _ = self.grid2mesh({'grid': grid_in,
                               'mesh': bcast(self.mesh_struct)},
                              {'g2m': bcast(self.g2m_edge_feats)}, cond)
    latent_grid, latent_mesh = nodes['grid'], nodes['mesh']
    latent_mesh = self.processor(latent_mesh, cond).to(dtype)
    nodes, _ = self.mesh2grid({'grid': latent_grid, 'mesh': latent_mesh},
                              {'m2g': bcast(self.m2g_edge_feats)}, cond)
    return nodes['grid']


class Denoiser(nn.Module):
  """Noise-conditioned denoiser over packed [B, lat, lon, C] tensors.

  Appends noisy targets to forcings channel-wise (static permutation),
  encodes the noise level into the FiLM conditioning vector, and runs the
  architecture.
  """

  def __init__(self, task: TaskSpec, statics: GraphStatics,
               transformer: TransformerConfig,
               config: DenoiserConfig = DenoiserConfig(), *,
               rng: torch.Generator, use_kernels: bool = True):
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
        rng=rng, use_kernels=use_kernels)

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
