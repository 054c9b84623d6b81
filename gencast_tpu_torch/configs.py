"""Model configurations and factories for the port.

Counterpart of `gencast_tpu.configs` for the configurations the port runs:
the reference's CPU-sized TINY (einsum tri-block attention) and its
variants on the kernels' backends, TINY_PALLAS (block-sparse) and
TINY_TRIBLOCK (fused tri-block), the reference's demo model NANO (tri-block
attention), the 1-degree GenCast ONE_DEG and the paper-scale 0.25-degree
GenCast QUARTER_DEG (both block-sparse attention). `build_gencast` builds GenCast
from a preset, `build_graphcast` GraphCast (at ONE_DEG: GraphCast_small).
Graph statics are cached on disk (`build_statics`), keyed by what they are
built from.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from gencast_tpu_torch.data import registry
from gencast_tpu_torch.graph import compiler
from gencast_tpu_torch.models.denoiser import DenoiserConfig
from gencast_tpu_torch.models.gencast import GenCast, SamplerConfig
from gencast_tpu_torch.models.graphcast import GraphCast, GraphCastConfig
from gencast_tpu_torch.nn.transformer import TransformerConfig

# Where `build_statics` keeps its pickled GraphStatics: under
# $GENCAST_TPU_TORCH_CACHE when set, else beside the kernels' builds in the
# checkout's git-ignored build/ directory. The port's statics are not the
# JAX package's (another module tree), so they never share its cache.
DEFAULT_CACHE_DIR = os.path.join(
    os.environ.get('GENCAST_TPU_TORCH_CACHE',
                   os.path.join(os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))), 'build')),
    'gencast_tpu_torch', 'statics')


@dataclasses.dataclass(frozen=True)
class ModelSpec:
  """One named model configuration."""
  name: str
  task: registry.TaskSpec
  resolution_deg: float
  mesh_splits: int
  d_model: int
  num_layers: int
  num_heads: int
  attention_k_hop: int
  # The mesh transformer's attention backend, by the reference's names:
  # 'pallas' (block-sparse over a tile plan, kernels A and F on the card),
  # 'triblock_pallas' (tri-block over the banded mask, kernels C and D), or
  # the reference's plain einsum math: 'triblock' (the banded mask; its
  # default) and 'dense' (the [N, N] k-hop mask).
  attention_type: str = 'pallas'
  # Tile of the block-sparse attention plan. The attention kernel is built
  # for tile 64; the plain version takes any tile.
  attention_tile_size: int = 64
  ffw_hidden: int = 2048
  hidden_layers: int = 1
  radius_query_fraction_edge_length: float = 0.6
  stochastic_churn_rate: float = 0.0
  num_noise_levels: int = 20
  # Storage dtype of the spherical-harmonic noise basis ('float32' or
  # 'bfloat16'); synthesis sums in float32 either way (ops/sph_harm.py).
  noise_basis_dtype: str = 'float32'
  # Streamed edges in the grid2mesh / mesh2grid GNNs: edges go through the
  # edge MLP and the receiver sum this many at a time (nn/gnn.py); None
  # keeps the dense path.
  edge_chunk_size: Optional[int] = None
  # Planned aggregation for skewed edge sides, and its degree gate.
  use_agg_plans: bool = False
  agg_plan_min_degree: int = 32
  # Run under models.casting.Bfloat16Cast (bf16 compute, float32 masters).
  cast_bf16: bool = False
  # Transformer remat in the backward pass (nn.transformer.TransformerConfig):
  # 'full' recomputes whole blocks, 'save_attention' keeps the attention
  # half and recomputes only LN/FiLM/FFW.
  remat_policy: str = 'full'
  # Whole-GNN remat of the encoder and decoder (DenoiserConfig.remat_gnns).
  remat_gnns: bool = False


# The reference's CPU-sized configuration (`--preset tiny`), field for
# field: 10-degree grid, mesh splits 2 (162 nodes), d_model 64, 2 layers,
# 2 heads, k-hop 4, the einsum tri-block attention (plain PyTorch) over a
# [3, 2, 88, 88] mask, float32. Not one of DeepMind's presets.
TINY = ModelSpec(
    name='tiny', task=registry.GENCAST_TASK, resolution_deg=10.0,
    mesh_splits=2, d_model=64, num_layers=2, num_heads=2,
    attention_k_hop=4, ffw_hidden=128, attention_type='triblock',
    attention_tile_size=512)

# TINY on the kernels' backends, for tests and card checks: block-sparse at
# tile 32 (6 query tiles, the last ragged), and the fused tri-block over the
# same [3, 2, 88, 88] mask (block 88, 14 padding nodes), so kernels C and D
# see a ragged 24-row sub-tile.
TINY_PALLAS = dataclasses.replace(TINY, name='tiny_pallas',
                                  attention_type='pallas',
                                  attention_tile_size=32)
TINY_TRIBLOCK = dataclasses.replace(TINY, name='tiny_triblock',
                                    attention_type='triblock_pallas')

# The reference's demo model, exactly as its NANO (training/train.py's
# default preset): 2.5-degree grid (73 x 144), mesh splits 4 (2,562 nodes),
# d_model 256, 16 layers, 4 heads, k-hop 8, tri-block attention over a
# [3, 4, 656, 656] mask, bf16 compute with float32 masters, 'full' remat,
# no aggregation plans, churn 0, 20 noise levels.
NANO = ModelSpec(
    name='nano', task=registry.GENCAST_TASK, resolution_deg=2.5,
    mesh_splits=4, d_model=256, num_layers=16, num_heads=4,
    attention_k_hop=8, attention_type='triblock_pallas', cast_bf16=True)

# GenCast 1 degree: splits 5, full variable set, bf16, churn 2.5, planned
# aggregation, save_attention remat, as the reference's ONE_DEG. The tile
# is the port's own: the reference's 768 was a TPU on-chip-memory choice.
# On the k-hop-16 mask, tiles of 64 and 128 cover nearly the same masked
# area (10,601 pairs of 64 x 64 = 43.4 M entries against 2,741 pairs of
# 128 x 128 = 44.9 M), and 64 keeps one attention block at 85 KB of shared
# memory (two per SM).
ONE_DEG = ModelSpec(
    name='1deg', task=registry.GENCAST_TASK_FULL, resolution_deg=1.0,
    mesh_splits=5, d_model=512, num_layers=16, num_heads=4,
    attention_k_hop=16, attention_tile_size=64, stochastic_churn_rate=2.5,
    use_agg_plans=True, cast_bf16=True, remat_policy='save_attention')

# Paper-scale GenCast 0.25 degree: splits 6 (40,962 mesh nodes), the
# 721 x 1440 grid (1,038,240 nodes), d_model 512, 16 layers, k-hop 16, as
# the reference's QUARTER_DEG, with its memory fields: streamed edges in
# chunks of 128 Ki edges, whole-GNN remat, the noise basis stored in bf16.
# Aggregation plans keep the reference's default (off); on the card every
# side of non-uniform degree is planned anyway. The tile is the port's 64
# (the reference's 768 was a TPU on-chip-memory choice): 63,126 pairs of
# 64 x 64. The reference's donated-state step has no counterpart (eager
# updates are in place).
QUARTER_DEG = ModelSpec(
    name='0.25deg', task=registry.GENCAST_TASK_FULL, resolution_deg=0.25,
    mesh_splits=6, d_model=512, num_layers=16, num_heads=4,
    attention_k_hop=16, attention_tile_size=64, stochastic_churn_rate=2.5,
    edge_chunk_size=128 * 1024, noise_basis_dtype='bfloat16',
    remat_policy='save_attention', remat_gnns=True, cast_bf16=True)


def grid_for_resolution(deg: float) -> Tuple[np.ndarray, np.ndarray]:
  """Equiangular grid with poles: lat ascending [-90, 90], lon [0, 360)."""
  lat = np.arange(-90.0, 90.0 + deg / 2, deg, dtype=np.float32)
  lon = np.arange(0.0, 360.0, deg, dtype=np.float32)
  return lat, lon


SPECS = {s.name: s for s in (TINY, TINY_PALLAS, TINY_TRIBLOCK, NANO,
                              ONE_DEG, QUARTER_DEG)}


def build_statics(spec: ModelSpec,
                  cache_dir: Optional[str] = DEFAULT_CACHE_DIR
                  ) -> compiler.GraphStatics:
  """The spec's graph statics, with what its attention backend reads: the
  tile plan for 'pallas', the tri-block mask for 'triblock_pallas' and
  'triblock' ('dense' reads the mesh edges: `dense_attention_mask`). Loaded
  from `cache_dir` when built there before (None: no cache)."""
  lat, lon = grid_for_resolution(spec.resolution_deg)
  return compiler.build_graph_statics(
      spec.mesh_splits, lat, lon,
      radius_query_fraction_edge_length=(
          spec.radius_query_fraction_edge_length),
      attention_k_hop=spec.attention_k_hop,
      attention_tile_size=(spec.attention_tile_size
                           if spec.attention_type == 'pallas' else 0),
      build_triblock_mask=spec.attention_type in ('triblock_pallas',
                                                  'triblock'),
      cache_dir=cache_dir)


def dense_attention_mask(statics: compiler.GraphStatics,
                         k_hop: int) -> np.ndarray:
  """The [N, N] bool k-hop mask of the mesh that 'dense' attention reads:
  the set the tile plan and the tri-block mask are built from
  (`compiler.khop_mask_csr`), as the reference's build_gencast makes it."""
  edges = statics.mesh_edges
  return compiler.khop_mask_csr(edges.senders, edges.receivers,
                                statics.num_mesh_nodes, k_hop).toarray()


def build_gencast(spec: ModelSpec, *, seed: int = 0,
                  statics: Optional[compiler.GraphStatics] = None,
                  device: torch.device | str = 'cuda',
                  use_kernels: bool = True,
                  node_sharding_axis: Optional[str] = None
                  ) -> Tuple[GenCast, compiler.GraphStatics]:
  """Builds a GenCast model (unwrapped; see models.wrappers for the
  normalization / bf16 stack) on `device` (the CUDA card unless the caller
  names another), plus its graph statics.

  Parameters are initialized from torch.Generator seeded with `seed`.
  use_kernels=False routes the attention and planned-sum forwards through
  their plain PyTorch versions on every device (for comparing the two
  serving paths on the card). A 'dense' spec gets the [N, N] k-hop mask
  (`dense_attention_mask`). `node_sharding_axis='model'` shards the grid
  nodes over the model axis once the model is sharded
  (`DenoiserConfig.node_sharding_axis`).
  """
  if statics is None:
    statics = build_statics(spec)
  dense_mask = (dense_attention_mask(statics, spec.attention_k_hop)
                if spec.attention_type == 'dense' else None)
  transformer = TransformerConfig(
      d_model=spec.d_model, num_layers=spec.num_layers,
      num_heads=spec.num_heads, ffw_hidden=spec.ffw_hidden,
      attention_type=spec.attention_type, remat_policy=spec.remat_policy)
  model = GenCast(
      spec.task, statics, transformer,
      denoiser_config=DenoiserConfig(
          latent_size=spec.d_model, hidden_layers=spec.hidden_layers,
          use_agg_plans=spec.use_agg_plans,
          agg_plan_min_degree=spec.agg_plan_min_degree,
          edge_chunk_size=spec.edge_chunk_size,
          remat_gnns=spec.remat_gnns,
          node_sharding_axis=node_sharding_axis),
      sampler_config=SamplerConfig(
          stochastic_churn_rate=spec.stochastic_churn_rate,
          num_noise_levels=spec.num_noise_levels),
      rng=torch.Generator().manual_seed(seed),
      use_kernels=use_kernels,
      noise_basis_dtype=getattr(torch, spec.noise_basis_dtype),
      basis_device=device, dense_attention_mask=dense_mask)
  return model.to(device), statics


def build_graphcast(spec: ModelSpec, *, seed: int = 0,
                    statics: Optional[compiler.GraphStatics] = None,
                    device: torch.device | str = 'cuda',
                    cache_dir: Optional[str] = DEFAULT_CACHE_DIR,
                    use_kernels: bool = True,
                    **config_overrides
                    ) -> Tuple[GraphCast, compiler.GraphStatics]:
  """Builds a GraphCast from a ModelSpec on `device` (the CUDA card unless
  the caller names another), plus its graph statics (the multimesh, no
  attention mask; from `cache_dir` when built there before).

  As the reference's: a GenCast task of the spec (the presets carry them)
  becomes GRAPHCAST_TASK_13's variables at the spec's pressure levels, and
  any other task (graphcast_13, graphcast_37, ...) is used as given;
  num_layers is the number of processor steps (gnn_msg_steps). Keyword
  arguments override GraphCastConfig fields; remat_group > 1 implies
  remat=True unless remat is given. At ONE_DEG this is DeepMind's
  GraphCast_small: 1 degree, 13 levels, mesh levels up to splits 5, latent
  512, 16 steps, precipitation in and out. Parameters come from a
  torch.Generator seeded with `seed`; use_kernels=False sends the planned
  sums through their plain versions on every device.
  """
  if (config_overrides.get('remat_group', 1) > 1
      and 'remat' not in config_overrides and not spec.remat_gnns):
    config_overrides = dict(config_overrides, remat=True)
  gencast_families = {
      dataclasses.replace(t, pressure_levels=())
      for t in (registry.GENCAST_TASK, registry.GENCAST_TASK_FULL)}
  if dataclasses.replace(spec.task, pressure_levels=()) in gencast_families:
    task = dataclasses.replace(registry.GRAPHCAST_TASK_13,
                               pressure_levels=spec.task.pressure_levels)
  else:
    task = spec.task
  if statics is None:
    lat, lon = grid_for_resolution(spec.resolution_deg)
    statics = compiler.build_graph_statics(
        spec.mesh_splits, lat, lon,
        radius_query_fraction_edge_length=(
            spec.radius_query_fraction_edge_length),
        build_multimesh=True, cache_dir=cache_dir)
  config = dataclasses.replace(
      GraphCastConfig(latent_size=spec.d_model,
                      gnn_msg_steps=spec.num_layers,
                      hidden_layers=spec.hidden_layers,
                      edge_chunk_size=spec.edge_chunk_size,
                      remat=spec.remat_gnns),
      **config_overrides)
  model = GraphCast(task, statics, config,
                    rng=torch.Generator().manual_seed(seed),
                    use_kernels=use_kernels)
  return model.to(device), statics
