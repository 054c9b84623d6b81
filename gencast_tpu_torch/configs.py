"""Model configurations and factories for the port.

Counterpart of `gencast_tpu.configs` for the configurations the port runs:
the CPU-sized TINY and the 1-degree GenCast (ONE_DEG), both on the
block-sparse attention backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gencast_tpu_torch.data import registry
from gencast_tpu_torch.graph import compiler
from gencast_tpu_torch.models.denoiser import DenoiserConfig
from gencast_tpu_torch.models.gencast import GenCast, SamplerConfig
from gencast_tpu_torch.nn.transformer import TransformerConfig


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
  # Tile of the block-sparse attention plan. The attention kernel is built
  # for tile 64; the plain version takes any tile.
  attention_tile_size: int = 64
  ffw_hidden: int = 2048
  hidden_layers: int = 1
  radius_query_fraction_edge_length: float = 0.6
  stochastic_churn_rate: float = 0.0
  num_noise_levels: int = 20
  # Planned aggregation for skewed edge sides, and its degree gate.
  use_agg_plans: bool = False
  agg_plan_min_degree: int = 32
  # Run under models.casting.Bfloat16Cast (bf16 compute, float32 masters).
  cast_bf16: bool = False
  # Transformer remat in the backward pass (nn.transformer.TransformerConfig):
  # 'full' recomputes whole blocks, 'save_attention' keeps the attention
  # half and recomputes only LN/FiLM/FFW.
  remat_policy: str = 'full'


# CPU-sized configuration for tests; not a reference preset.
TINY = ModelSpec(
    name='tiny', task=registry.GENCAST_TASK, resolution_deg=10.0,
    mesh_splits=2, d_model=64, num_layers=2, num_heads=2,
    attention_k_hop=4, ffw_hidden=128, attention_tile_size=32)

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


def grid_for_resolution(deg: float) -> Tuple[np.ndarray, np.ndarray]:
  """Equiangular grid with poles: lat ascending [-90, 90], lon [0, 360)."""
  lat = np.arange(-90.0, 90.0 + deg / 2, deg, dtype=np.float32)
  lon = np.arange(0.0, 360.0, deg, dtype=np.float32)
  return lat, lon


def build_statics(spec: ModelSpec) -> compiler.GraphStatics:
  lat, lon = grid_for_resolution(spec.resolution_deg)
  return compiler.build_graph_statics(
      spec.mesh_splits, lat, lon,
      radius_query_fraction_edge_length=(
          spec.radius_query_fraction_edge_length),
      attention_k_hop=spec.attention_k_hop,
      attention_tile_size=spec.attention_tile_size)


def build_gencast(spec: ModelSpec, *, seed: int = 0,
                  statics: Optional[compiler.GraphStatics] = None,
                  device: torch.device | str = 'cpu',
                  use_kernels: bool = True
                  ) -> Tuple[GenCast, compiler.GraphStatics]:
  """Builds a GenCast model (unwrapped; see models.wrappers for the
  normalization / bf16 stack) on `device`, plus its graph statics.

  Parameters are initialized from torch.Generator seeded with `seed`.
  use_kernels=False routes the attention and planned-sum forwards through
  their plain PyTorch versions on every device (for comparing the two
  serving paths on the card).
  """
  if statics is None:
    statics = build_statics(spec)
  transformer = TransformerConfig(
      d_model=spec.d_model, num_layers=spec.num_layers,
      num_heads=spec.num_heads, ffw_hidden=spec.ffw_hidden,
      remat_policy=spec.remat_policy)
  model = GenCast(
      spec.task, statics, transformer,
      denoiser_config=DenoiserConfig(
          latent_size=spec.d_model, hidden_layers=spec.hidden_layers,
          use_agg_plans=spec.use_agg_plans,
          agg_plan_min_degree=spec.agg_plan_min_degree),
      sampler_config=SamplerConfig(
          stochastic_churn_rate=spec.stochastic_churn_rate,
          num_noise_levels=spec.num_noise_levels),
      rng=torch.Generator().manual_seed(seed),
      use_kernels=use_kernels)
  return model.to(device), statics
