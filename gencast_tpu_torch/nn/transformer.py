"""Sparse mesh transformer over RCM-permuted mesh nodes.

Counterpart of `gencast_tpu.nn.transformer.MeshTransformer` with its four
attention backends, by the reference's names: 'pallas' (block-sparse
attention over a `TilePlan`, kernels A and F on the card, or A and G under
GENCAST_SPARSE_FUSED_BWD=1), 'triblock_pallas' (tri-block attention over
the banded mask, kernels C and D), and the reference's plain einsum math,
plain PyTorch on every device: 'triblock' (the same tri-block attention
with one joint softmax over the three key blocks) and 'dense' (masked
attention over an [N, N] k-hop mask). Pre-LN blocks with FiLM noise
conditioning on both sublayers. The reference's vmapped layer stack and
lax.scan become an nn.ModuleList walked by a Python loop, and its remat
policies `torch.utils.checkpoint` (nn/remat.py) around each block ('full')
or around its feed-forward half only ('save_attention').
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch.graph.compiler import BandedMask
from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.nn import precision, remat
from gencast_tpu_torch.nn.mlp import FiLM, Linear, gelu, ln_film, \
    variance_scaling
from gencast_tpu_torch.ops import banded_attention, sparse_attention
from gencast_tpu_torch.parallel import tensor

REMAT_POLICIES = ('full', 'save_attention')
ATTENTION_TYPES = ('pallas', 'triblock_pallas', 'triblock', 'dense')
# The reference's switch to its fused block-sparse attention backward
# (`gencast_tpu.ops.sparse_attention._FUSED_BWD`): same name, values and
# default (off).
FUSED_BWD_ENV = 'GENCAST_SPARSE_FUSED_BWD'


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
  """The reference's transformer hyperparameters (its SparseTransformerConfig
  defaults), for the ported attention backends."""
  d_model: int
  num_layers: int = 16
  num_heads: int = 4
  ffw_hidden: int = 2048
  # 'pallas' (block-sparse over a tile plan), 'triblock_pallas' (tri-block
  # over the banded mask), or the reference's einsum 'triblock' (the banded
  # mask) and 'dense' (an [N, N] mask).
  attention_type: str = 'pallas'
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
    if self.attention_type not in ATTENTION_TYPES:
      raise ValueError(f'attention_type must be one of {ATTENTION_TYPES}, got '
                       f'{self.attention_type!r}')

  @property
  def head_dim(self) -> int:
    if self.d_model % self.num_heads:
      raise ValueError('num_heads must divide d_model')
    return self.d_model // self.num_heads


def _scaled_init(scale: float, num_layers: int):
  return variance_scaling(scale / num_layers, 'truncated_normal')


class _QKVProjections(nn.Module):
  """q/k/v (no bias) and output projections. Under a model axis
  (parallel/tensor.py) q, k and v hold this rank's heads and `out` sums
  the ranks' partial products."""

  model_axis: Optional[tensor.ModelAxis] = None

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
    # This rank's heads: all of them without a model axis.
    hd = self.cfg.head_dim
    h = self.q.weight.shape[0] // hd
    x = tensor.copy_in(x, self.model_axis)

    def s(y):
      return y.reshape(y.shape[:-1] + (h, hd))
    return s(self.q(x)), s(self.k(x)), s(self.v(x))


class PallasSparseAttention(nn.Module):
  """Block-sparse attention over the tile plan (kernels A and F, or A and G,
  on the card; named after the reference's backend so parameter paths
  match)."""

  def __init__(self, cfg: TransformerConfig, tile: int, *,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rng=rng)
    self.tile = tile
    self.use_kernels = use_kernels

  def forward(self, x: torch.Tensor, plan: Tuple[torch.Tensor, ...]
              ) -> torch.Tensor:
    # plan: mask_tiles, fwd_kv_ids, fwd_pair_ids, bwd_q_ids, bwd_pair_ids,
    # and under the fused backward slot_ids, valid.
    q, k, v = self.proj.split_heads(x)  # [B, N, H, hd]
    if self.use_kernels:
      o = sparse_attention.sparse_banded_attention(
          q, k, v, *plan[:3], self.tile, *plan[3:])
    else:
      o = sparse_attention.sparse_banded_attention_plain(
          q, k, v, *plan[:3], self.tile)
    return self.proj.out(o.reshape(o.shape[:2] + (-1,)))


class TriblockPallasAttention(nn.Module):
  """Tri-block attention over the banded mask (kernels C and D on the card;
  named after the reference's backend so parameter paths match). Its input
  is already padded to num_blocks * block_size nodes."""

  def __init__(self, cfg: TransformerConfig, block_size: int, *,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rng=rng)
    self.block_size = block_size
    self.use_kernels = use_kernels

  def forward(self, x: torch.Tensor, operands: Tuple[torch.Tensor, ...]
              ) -> torch.Tensor:
    (mask_blocks,) = operands  # [3, nb, bs, bs] uint8
    q, k, v = self.proj.split_heads(x)  # [B, N, H, hd]
    if self.use_kernels:
      o = banded_attention.banded_attention(q, k, v, mask_blocks,
                                            self.block_size)
    else:
      o = banded_attention.banded_attention_plain(q, k, v, mask_blocks,
                                                  self.block_size)
    return self.proj.out(o.reshape(o.shape[:2] + (-1,)))


def _joint_softmax3(logits):
  """Softmax over the union of the diagonal, upper and lower key blocks,
  sharing one maximum (DeepMind's gencast/sparse_transformer.py)."""
  d, u, l = logits
  m = torch.stack([t.detach().amax(-1, keepdim=True) for t in (d, u, l)]
                  ).amax(0)
  ed, eu, el = torch.exp(d - m), torch.exp(u - m), torch.exp(l - m)
  denom = (ed.sum(-1, keepdim=True) + eu.sum(-1, keepdim=True)
           + el.sum(-1, keepdim=True))
  return ed / denom, eu / denom, el / denom


class TriblockAttention(nn.Module):
  """Tri-block attention as the reference's einsum math: each block of
  queries against its diagonal, upper and lower key blocks, one softmax
  over the three in float32 (`precision.with_f32`). Plain PyTorch on every
  device. Its input is already padded to num_blocks * block_size nodes. A
  query row without a key (the padding) gets a finite masked-softmax
  value where the kernels write 0; nothing reads it."""

  def __init__(self, cfg: TransformerConfig, block_size: int, *,
               rng: torch.Generator):
    super().__init__()
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rng=rng)
    self.block_size = block_size

  def forward(self, x: torch.Tensor, operands: Tuple[torch.Tensor, ...]
              ) -> torch.Tensor:
    (mask,) = operands  # [3, nb, bs, bs] bool: diagonal, upper, lower
    b, n, _ = x.shape
    bs = self.block_size
    nb = n // bs
    q, k, v = self.proj.split_heads(x.reshape(b, nb, bs, -1))
    # [B, nb, bs, H, hd]; one zero block either side of the keys and values.
    def ring(t):
      zero = torch.zeros_like(t[:, :1])
      return torch.cat([zero, t, zero], dim=1)
    k, v = ring(k), ring(v)
    scale = self.cfg.head_dim ** -0.5
    # The key blocks of each query block: diagonal, upper (next), lower
    # (previous); masked logits -1e30 in the logits' dtype, as the
    # reference's.
    blocks = ((0, slice(1, -1)), (1, slice(2, None)), (2, slice(None, -2)))
    logits = tuple(
        (torch.einsum('bnqhd,bnkhd->bnhqk', q, k[:, kb]) * scale).masked_fill(
            ~mask[i][None, :, None], -1e30)
        for i, kb in blocks)
    weights = precision.with_f32(_joint_softmax3, logits)
    o = None
    for w, (_, kb) in zip(weights, blocks):
      term = torch.einsum('bnhqk,bnkhd->bnqhd', w, v[:, kb])
      o = term if o is None else o + term
    return self.proj.out(o.reshape(b, n, -1))


class DenseAttention(nn.Module):
  """Masked attention over all mesh nodes, as the reference's einsum math
  (DeepMind's multi-head attention path): [N, N] logits, a float32 softmax
  (`precision.with_f32`). Plain PyTorch on every device."""

  def __init__(self, cfg: TransformerConfig, *, rng: torch.Generator):
    super().__init__()
    self.cfg = cfg
    self.proj = _QKVProjections(cfg, rng=rng)

  def forward(self, x: torch.Tensor, operands: Tuple[torch.Tensor, ...]
              ) -> torch.Tensor:
    (mask,) = operands  # [N, N] bool
    q, k, v = self.proj.split_heads(x)  # [B, N, H, hd]
    logits = torch.einsum('bthd,bThd->bhtT', q, k) * self.cfg.head_dim ** -0.5
    logits = logits.masked_fill(~mask[None, None], -1e30)
    weights = precision.with_f32(lambda t: torch.softmax(t, dim=-1), logits)
    o = torch.einsum('bhtT,bThd->bthd', weights, v)
    return self.proj.out(o.reshape(o.shape[:2] + (-1,)))


class FeedForward(nn.Module):
  """lin2(gelu(lin1(x))); under a model axis a column/row pair over the
  hidden width (parallel/tensor.py)."""

  model_axis: Optional[tensor.ModelAxis] = None

  def __init__(self, cfg: TransformerConfig, *, rng: torch.Generator):
    super().__init__()
    self.lin1 = Linear(cfg.d_model, cfg.ffw_hidden, rng=rng,
                       init=_scaled_init(cfg.ffw_winit_mult, cfg.num_layers))
    self.lin2 = Linear(
        cfg.ffw_hidden, cfg.d_model, rng=rng,
        init=_scaled_init(cfg.ffw_winit_final_mult, cfg.num_layers))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.lin2(gelu(self.lin1(tensor.copy_in(x, self.model_axis))))


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
                operands: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    # x: [B, N, C]; cond: [B, D]; operands: the attention's plan or mask.
    return x + self.attn(ln_film(x, self.film1, cond), operands)

  def ffw_half(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return x + self.ffw(ln_film(x, self.film2, cond))

  def forward(self, x: torch.Tensor, cond: torch.Tensor,
              operands: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    return self.ffw_half(self.attn_half(x, cond, operands), cond)


class MeshTransformer(nn.Module):
  """Stack of sparse attention blocks over mesh nodes.

  Input/output layout [N, B, C] (nodes leading, as the GNNs); batch-first
  inside. The node axis is padded once before the stack (to the plan's
  padded_n, or to num_blocks * block_size of the tri-block mask) and sliced
  once after it; padded rows are masked as keys, give 0 as queries (the
  kernels) or a finite masked-softmax value (the einsum 'triblock'), and
  stay finite through LN/FiLM/FFW. 'dense' runs unpadded.

  With the 'pallas' backend, GENCAST_SPARSE_FUSED_BWD=1 selects the fused
  attention backward (kernel G) as in the reference: the plan's gather map
  (`graph.plans.build_bwd_gather`) is kept as the buffers `slot_ids` and
  `valid` and handed to the attention, whose backward then runs G instead of
  F. The variable is read when the transformer is built (the reference reads
  it once, at import), so one process can build both variants.
  """

  def __init__(self, cfg: TransformerConfig, *,
               tile_plan: Optional[plans.TilePlan] = None,
               mask: Optional[BandedMask] = None,
               dense_mask: Optional[np.ndarray] = None,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    self.cfg = cfg
    kind = cfg.attention_type
    if kind == 'pallas':
      if tile_plan is None:
        raise ValueError('pallas attention needs statics built with an '
                         'attention tile plan (attention_tile_size > 0)')
      self.operand_names = ('mask_tiles', 'fwd_kv_ids', 'fwd_pair_ids',
                            'bwd_q_ids', 'bwd_pair_ids')
      operands = {name: getattr(tile_plan, name)
                  for name in self.operand_names}
      if os.environ.get(FUSED_BWD_ENV, '0') == '1':
        operands['slot_ids'], operands['valid'] = plans.build_bwd_gather(
            tile_plan)
        self.operand_names += ('slot_ids', 'valid')
      self.padded_n = tile_plan.padded_n

      def make_attn():
        return PallasSparseAttention(cfg, tile_plan.tile, rng=rng,
                                     use_kernels=use_kernels)
    elif kind == 'dense':
      if dense_mask is None:
        raise ValueError('dense attention needs the [N, N] k-hop mask '
                         '(configs.build_gencast builds it)')
      self.operand_names = ('dense_mask',)
      operands = {'dense_mask': np.asarray(dense_mask, dtype=bool)}
      self.padded_n = 0

      def make_attn():
        return DenseAttention(cfg, rng=rng)
    else:
      if mask is None:
        raise ValueError(f'{kind} attention needs statics built with the '
                         'tri-block mask (build_triblock_mask)')
      # The kernels read a uint8 mask, the einsum path a bool one.
      self.operand_names = ('mask_blocks',)
      operands = {'mask_blocks': mask.blocks.astype(
          np.uint8 if kind == 'triblock_pallas' else bool)}
      self.padded_n = mask.num_blocks * mask.block_size

      def make_attn():
        if kind == 'triblock':
          return TriblockAttention(cfg, mask.block_size, rng=rng)
        return TriblockPallasAttention(cfg, mask.block_size, rng=rng,
                                       use_kernels=use_kernels)
    for name, array in operands.items():
      self.register_buffer(name, torch.as_tensor(array), persistent=False)
    self.blocks = nn.ModuleList(
        TransformerBlock(cfg, make_attn(), rng=rng)
        for _ in range(cfg.num_layers))
    self.final_film = FiLM(cfg.d_model, rng=rng)

  def forward(self, node_feats: torch.Tensor,
              cond: torch.Tensor) -> torch.Tensor:
    n = node_feats.shape[0]
    x = node_feats.transpose(0, 1)  # [B, N, C]
    if self.padded_n > n:
      x = torch.nn.functional.pad(x, (0, 0, 0, self.padded_n - n))
    operands = tuple(getattr(self, name) for name in self.operand_names)
    recompute = torch.is_grad_enabled()
    for block in self.blocks:
      if not recompute:
        y = block(x, cond, operands)
      elif self.cfg.remat_policy == 'save_attention':
        y = remat.checkpoint(block, block.ffw_half,
                             block.attn_half(x, cond, operands), cond)
      else:
        y = remat.checkpoint(block, block, x, cond, operands)
      # Keep the carry dtype (float32 parameters promote bf16 activations).
      x = y.to(x.dtype)
    h = ln_film(x, self.final_film, cond)
    return h[:, :n].transpose(0, 1)
