"""Block-sparse mesh transformer over RCM-permuted mesh nodes.

Counterpart of `gencast_tpu.nn.transformer.MeshTransformer` with its
'pallas' backend: pre-LN blocks with FiLM noise conditioning on both
sublayers, attention restricted to the k-hop mask through a `TilePlan`
(kernels A and F on the card). The reference's vmapped layer stack and
lax.scan become an nn.ModuleList walked by a Python loop, and its remat
policies `torch.utils.checkpoint` (nn/remat.py) around each block ('full')
or around its feed-forward half only ('save_attention'). Its other
attention backends (tri-block, dense) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from gencast_tpu_torch.graph.plans import TilePlan
from gencast_tpu_torch.nn import remat
from gencast_tpu_torch.nn.mlp import FiLM, Linear, gelu, ln_film, \
    variance_scaling
from gencast_tpu_torch.ops import sparse_attention

REMAT_POLICIES = ('full', 'save_attention')


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
  # What the backward pass recomputes (whenever gradients are recorded):
  # 'full' checkpoints each whole block; 'save_attention' keeps the
  # attention half (its forward's saved tensors) and recomputes only
  # LN/FiLM/FFW.
  remat_policy: str = 'full'

  def __post_init__(self):
    if self.remat_policy not in REMAT_POLICIES:
      raise ValueError(f'remat_policy must be one of {REMAT_POLICIES}, got '
                       f'{self.remat_policy!r}')

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
  """Block-sparse attention over the tile plan (kernels A and F on the card;
  named after the reference's backend so parameter paths match)."""

  def __init__(self, cfg: TransformerConfig, tile: int, *,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rng=rng)
    self.tile = tile
    self.use_kernels = use_kernels

  def forward(self, x: torch.Tensor, plan: Tuple[torch.Tensor, ...]
              ) -> torch.Tensor:
    # plan: mask_tiles, fwd_kv_ids, fwd_pair_ids, bwd_q_ids, bwd_pair_ids.
    q, k, v = self.proj.split_heads(x)  # [B, N, H, hd]
    if self.use_kernels:
      o = sparse_attention.sparse_banded_attention(
          q, k, v, *plan[:3], self.tile, *plan[3:])
    else:
      o = sparse_attention.sparse_banded_attention_plain(
          q, k, v, *plan[:3], self.tile)
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

  def attn_half(self, x: torch.Tensor, cond: torch.Tensor,
                plan: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    # x: [B, N, C]; cond: [B, D].
    return x + self.attn(ln_film(x, self.film1, cond), plan)

  def ffw_half(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return x + self.ffw(ln_film(x, self.film2, cond))

  def forward(self, x: torch.Tensor, cond: torch.Tensor,
              plan: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    return self.ffw_half(self.attn_half(x, cond, plan), cond)


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
    for name in ('mask_tiles', 'fwd_kv_ids', 'fwd_pair_ids', 'bwd_q_ids',
                 'bwd_pair_ids'):
      self.register_buffer(name, torch.as_tensor(getattr(tile_plan, name)),
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
    plan = (self.mask_tiles, self.fwd_kv_ids, self.fwd_pair_ids,
            self.bwd_q_ids, self.bwd_pair_ids)
    recompute = torch.is_grad_enabled()
    for block in self.blocks:
      if not recompute:
        y = block(x, cond, plan)
      elif self.cfg.remat_policy == 'save_attention':
        y = remat.checkpoint(block, block.ffw_half,
                             block.attn_half(x, cond, plan), cond)
      else:
        y = remat.checkpoint(block, block, x, cond, plan)
      # Keep the carry dtype (float32 parameters promote bf16 activations).
      x = y.to(x.dtype)
    h = ln_film(x, self.final_film, cond)
    return h[:, :n].transpose(0, 1)
