"""Block-sparse mesh transformer over RCM-permuted mesh nodes.

Counterpart of `gencast_tpu.nn.transformer.MeshTransformer` with its
'pallas' backend: pre-LN blocks with FiLM noise conditioning on both
sublayers, attention restricted to the k-hop mask through a `TilePlan`
(kernel A on the card). The reference's vmapped layer stack and lax.scan
become an nn.ModuleList walked by a Python loop; its other attention
backends (tri-block, dense) and remat policies are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from gencast_tpu_torch.graph.plans import TilePlan
from gencast_tpu_torch.nn.mlp import FiLM, Linear, gelu, ln_film, \
    variance_scaling
from gencast_tpu_torch.ops import sparse_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
  """The reference's transformer hyperparameters (its SparseTransformerConfig
  defaults), for the block-sparse backend."""
  d_model: int
  num_layers: int = 16
  num_heads: int = 4
  ffw_hidden: int = 2048
  ffw_winit_mult: float = 2.0
  ffw_winit_final_mult: float = 0.0
  attn_winit_mult: float = 2.0
  attn_winit_final_mult: float = 0.0

  @property
  def head_dim(self) -> int:
    if self.d_model % self.num_heads:
      raise ValueError('num_heads must divide d_model')
    return self.d_model // self.num_heads


def _scaled_init(scale: float, num_layers: int):
  return variance_scaling(scale / num_layers, 'truncated_normal')


class _QKVProjections(nn.Module):
  """q/k/v (no bias) and output projections."""

  def __init__(self, cfg: TransformerConfig, *, rng: torch.Generator):
    super().__init__()
    self.cfg = cfg
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    init = _scaled_init(cfg.attn_winit_mult, cfg.num_layers)
    self.q = Linear(d, h * hd, rng=rng, init=init, bias=False)
    self.k = Linear(d, h * hd, rng=rng, init=init, bias=False)
    self.v = Linear(d, h * hd, rng=rng, init=init, bias=False)
    self.out = Linear(
        h * hd, d, rng=rng,
        init=_scaled_init(cfg.attn_winit_final_mult, cfg.num_layers))

  def split_heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    h, hd = self.cfg.num_heads, self.cfg.head_dim
    def s(y):
      return y.reshape(y.shape[:-1] + (h, hd))
    return s(self.q(x)), s(self.k(x)), s(self.v(x))


class PallasSparseAttention(nn.Module):
  """Block-sparse attention over the tile plan (kernel A on the card; named
  after the reference's backend so parameter paths match)."""

  def __init__(self, cfg: TransformerConfig, tile: int, *,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rng=rng)
    self.tile = tile
    self.attend = (sparse_attention.sparse_banded_attention if use_kernels
                   else sparse_attention.sparse_banded_attention_plain)

  def forward(self, x: torch.Tensor, plan: Tuple[torch.Tensor, ...]
              ) -> torch.Tensor:
    mask_tiles, fwd_ids, fwd_pids = plan
    q, k, v = self.proj.split_heads(x)  # [B, N, H, hd]
    o = self.attend(q, k, v, mask_tiles, fwd_ids, fwd_pids, self.tile)
    return self.proj.out(o.reshape(o.shape[:2] + (-1,)))


class FeedForward(nn.Module):

  def __init__(self, cfg: TransformerConfig, *, rng: torch.Generator):
    super().__init__()
    self.lin1 = Linear(cfg.d_model, cfg.ffw_hidden, rng=rng,
                       init=_scaled_init(cfg.ffw_winit_mult, cfg.num_layers))
    self.lin2 = Linear(
        cfg.ffw_hidden, cfg.d_model, rng=rng,
        init=_scaled_init(cfg.ffw_winit_final_mult, cfg.num_layers))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.lin2(gelu(self.lin1(x)))


class TransformerBlock(nn.Module):
  """Pre-LN block with FiLM noise conditioning on both sublayers (the
  LayerNorms have no parameters)."""

  def __init__(self, cfg: TransformerConfig, attn: nn.Module, *,
               rng: torch.Generator):
    super().__init__()
    self.attn = attn
    self.ffw = FeedForward(cfg, rng=rng)
    self.film1 = FiLM(cfg.d_model, rng=rng)
    self.film2 = FiLM(cfg.d_model, rng=rng)

  def forward(self, x: torch.Tensor, cond: torch.Tensor,
              plan: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    # x: [B, N, C]; cond: [B, 1, D].
    x = x + self.attn(ln_film(x, self.film1, cond), plan)
    return x + self.ffw(ln_film(x, self.film2, cond))


class MeshTransformer(nn.Module):
  """Stack of block-sparse attention blocks over mesh nodes.

  Input/output layout [N, B, C] (nodes leading, as the GNNs); batch-first
  inside. The node axis is padded once to the plan's padded_n before the
  stack and sliced once after it; padded rows are masked as keys, give 0 as
  queries, and stay finite through LN/FiLM/FFW.
  """

  def __init__(self, cfg: TransformerConfig, tile_plan: TilePlan, *,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    self.cfg = cfg
    self.padded_n = tile_plan.padded_n
    self.register_buffer('mask_tiles', torch.as_tensor(tile_plan.mask_tiles),
                         persistent=False)
    self.register_buffer('fwd_kv_ids', torch.as_tensor(tile_plan.fwd_kv_ids),
                         persistent=False)
    self.register_buffer('fwd_pair_ids',
                         torch.as_tensor(tile_plan.fwd_pair_ids),
                         persistent=False)
    self.blocks = nn.ModuleList(
        TransformerBlock(
            cfg, PallasSparseAttention(cfg, tile_plan.tile, rng=rng,
                                       use_kernels=use_kernels), rng=rng)
        for _ in range(cfg.num_layers))
    self.final_film = FiLM(cfg.d_model, rng=rng)

  def forward(self, node_feats: torch.Tensor,
              cond: torch.Tensor) -> torch.Tensor:
    n = node_feats.shape[0]
    x = node_feats.transpose(0, 1)  # [B, N, C]
    if self.padded_n > n:
      x = torch.nn.functional.pad(x, (0, 0, 0, self.padded_n - n))
    plan = (self.mask_tiles, self.fwd_kv_ids, self.fwd_pair_ids)
    cond_b = cond[:, None, :]
    for block in self.blocks:
      x = block(x, cond_b, plan).to(x.dtype)
    h = ln_film(x, self.final_film, cond_b)
    return h[:, :n].transpose(0, 1)
