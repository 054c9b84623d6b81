"""Tri-block (banded) attention over the RCM-banded mesh (kernels C and D).

`banded_attention` computes, for q/k/v [B, N, H, d] with N = nb * bs, the
softmax attention of every query node over the key nodes its k-hop mask
allows. The mesh is RCM-banded, so the allowed keys of query block j lie
in key blocks j - 1, j and j + 1, and the mask is given as
`graph.compiler.BandedMask.blocks`, [3, nb, bs, bs] (diagonal, upper,
lower; bool or uint8). One softmax runs over the three blocks jointly.
Rows that see no allowed key (padding) give exactly 0, and their row
log-sum-exp is +1e30, as in the reference (`gencast_tpu.ops.
banded_attention`), so the backward's exp(logits - lse) is 0 there.

It is a `torch.autograd.Function` with the reference's custom-VJP contract:
the forward saves the row log-sum-exp; the backward computes
delta = rowsum(dO * O) (float32, outside the kernels), then dq per query
block over its three key blocks, and dk/dv per key block over its three
query blocks (query block j + 1 sees key block j through mask[2][j + 1],
query block j - 1 through mask[1][j - 1]).

* On a CUDA tensor it launches the hand-written kernels: the forward
  `csrc/banded_attention.cu` (kernel C, which also writes the lse) and the
  backward `csrc/banded_attention_bwd.cu` (kernel D: dq, then dk/dv), or
  raises. Undifferentiated calls (sampling) go through kernel C as well.
* On a CPU tensor it runs the plain PyTorch versions of the same functions
  (`banded_attention_plain`, the counterpart of the reference's lse-free
  `_xla_forward`, and `banded_attention_dq_plain`,
  `banded_attention_dkv_plain`): the masked three-block arithmetic written
  out in float32 (float64 for float64 inputs).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gencast_tpu_torch.ops import cuda_lib
from gencast_tpu_torch.ops.sparse_attention import attention_delta

NEG_INF = -1e30

KERNEL = cuda_lib.KernelCounter(
    'banded_attention_fwd', 'gencast_tpu_torch/csrc/banded_attention.cu',
    'gencast_tpu/ops/banded_attention.py:34')
KERNEL_DQ = cuda_lib.KernelCounter(
    'banded_attention_bwd_dq',
    'gencast_tpu_torch/csrc/banded_attention_bwd.cu',
    'gencast_tpu/ops/banded_attention.py:74')
KERNEL_DKV = cuda_lib.KernelCounter(
    'banded_attention_bwd_dkv',
    'gencast_tpu_torch/csrc/banded_attention_bwd.cu',
    'gencast_tpu/ops/banded_attention.py:102')

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernels are compiled for: TINY (32) and NANO (64).
_HEAD_DIMS = (32, 64)
# Key block of each mask part relative to the query block: diagonal (0),
# upper (next block), lower (previous block).
_SHIFTS = (0, 1, -1)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
  return torch.promote_types(dtype, torch.float32)


def _blocks(x: torch.Tensor, bs: int, acc: torch.dtype) -> torch.Tensor:
  """[B, N, H, d] -> [B, nb, bs, H, d] in `acc`."""
  b, n, h, d = x.shape
  if n % bs:
    raise ValueError(f'{n} nodes are not a multiple of the block size {bs}')
  return x.to(acc).reshape(b, n // bs, bs, h, d)


def _row_blocks(x: torch.Tensor, bs: int, acc: torch.dtype) -> torch.Tensor:
  """[B, H, N] -> [B, nb, H, bs, 1] in `acc`."""
  b, h, n = x.shape
  return x.to(acc).reshape(b, h, n // bs, bs).transpose(1, 2)[..., None]


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
  """y[:, j] = x[:, j + s] along the block axis, zero past either end."""
  if s == 0:
    return x
  zero = torch.zeros_like(x[:, :1])
  if s > 0:
    return torch.cat([x[:, s:], zero], dim=1)
  return torch.cat([zero, x[:, :s]], dim=1)


def _allowed(mask_blocks: torch.Tensor, part: int) -> torch.Tensor:
  """Mask part as [1, nb, 1, bs, bs] bool, for [B, nb, H, q, k] logits."""
  return (mask_blocks[part] != 0)[None, :, None]


def _logits(qb, kb, part, scale):
  """[B, nb, H, q, k] scaled logits of each query block against the key
  block of mask part `part`."""
  keys = _shift(kb, _SHIFTS[part])
  return torch.einsum('bnqhd,bnkhd->bnhqk', qb, keys) * scale


def banded_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask_blocks: torch.Tensor, block_size: int,
                           return_lse: bool = False):
  """Plain PyTorch version of kernel C: q/k/v [B, N, H, d] -> [B, N, H, d]
  in the input dtype, and with return_lse also the row log-sum-exp
  [B, H, N] (float32, float64 for float64 inputs; +1e30 on rows that see no
  key). Computes in float32 (float64), with the probabilities unrounded, as
  the reference's `_xla_forward`."""
  b, n, h, d = q.shape
  acc = _acc_dtype(q.dtype)
  qb, kb, vb = (_blocks(x, block_size, acc) for x in (q, k, v))
  scale = d ** -0.5
  logits = [_logits(qb, kb, part, scale).masked_fill(
      ~_allowed(mask_blocks, part), NEG_INF) for part in range(3)]
  m = torch.stack([l.amax(dim=-1, keepdim=True) for l in logits]).amax(0)
  out = torch.zeros_like(qb)
  denom = torch.zeros_like(m)
  for part, l in enumerate(logits):
    p = torch.where(_allowed(mask_blocks, part), torch.exp(l - m), 0.0)
    denom = denom + p.sum(dim=-1, keepdim=True)
    out = out + torch.einsum('bnhqk,bnkhd->bnqhd', p,
                             _shift(vb, _SHIFTS[part]))
  valid = m > NEG_INF * 0.5                      # [B, nb, H, bs, 1]
  denom_q = denom.clamp_min(1e-30).permute(0, 1, 3, 2, 4)
  out = torch.where(valid.permute(0, 1, 3, 2, 4), out / denom_q, 0.0)
  out = out.reshape(b, n, h, d).to(q.dtype)
  if not return_lse:
    return out
  lse = torch.where(valid, m + torch.log(denom.clamp_min(1e-30)), -NEG_INF)
  return out, lse[..., 0].transpose(1, 2).reshape(b, h, n)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """x rounded to `dtype` and widened back: the value of a matmul operand
  the reference casts to the input dtype."""
  return x.to(dtype).to(x.dtype)


def _probs_and_ds(qb, kb, vb, dob, lse_b, delta_b, mask_blocks, part, scale,
                  dtype):
  """For mask part `part`: w = where(mask, exp(s * scale - lse), 0) and
  ds = w * (dO . V^T - delta) rounded to `dtype`, [B, nb, H, q, k]."""
  allowed = _allowed(mask_blocks, part)
  w = torch.where(allowed,
                  torch.exp(_logits(qb, kb, part, scale) - lse_b), 0.0)
  dp = torch.einsum('bnqhd,bnkhd->bnhqk', dob, _shift(vb, _SHIFTS[part]))
  return w, _round(w * (dp - delta_b), dtype)


def banded_attention_dq_plain(q, k, v, dout, lse, delta, mask_blocks,
                              block_size: int) -> torch.Tensor:
  """Plain PyTorch version of kernel D's dq: per query block, over its three
  key blocks, dq = scale * ds . K with ds rounded to the input dtype.
  q/k/v/dout [B, N, H, d], lse/delta [B, H, N] -> dq [B, N, H, d] in the
  input dtype."""
  b, n, h, d = q.shape
  acc = _acc_dtype(q.dtype)
  qb, kb, vb, dob = (_blocks(x, block_size, acc) for x in (q, k, v, dout))
  lse_b, delta_b = (_row_blocks(x, block_size, acc) for x in (lse, delta))
  scale = d ** -0.5
  dq = torch.zeros_like(qb)
  for part in range(3):
    _, ds = _probs_and_ds(qb, kb, vb, dob, lse_b, delta_b, mask_blocks, part,
                          scale, q.dtype)
    dq = dq + torch.einsum('bnhqk,bnkhd->bnqhd', ds,
                           _shift(kb, _SHIFTS[part]))
  return (dq * scale).reshape(b, n, h, d).to(q.dtype)


def banded_attention_dkv_plain(q, k, v, dout, lse, delta, mask_blocks,
                               block_size: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of kernel D's dk/dv: per key block j, over query
  blocks j - 1, j and j + 1, dv = w^T . dO and dk = scale * ds^T . Q, with w
  and ds rounded to the input dtype. Returns (dk, dv) [B, N, H, d] in the
  input dtype."""
  b, n, h, d = q.shape
  acc = _acc_dtype(q.dtype)
  qb, kb, vb, dob = (_blocks(x, block_size, acc) for x in (q, k, v, dout))
  lse_b, delta_b = (_row_blocks(x, block_size, acc) for x in (lse, delta))
  scale = d ** -0.5
  dk = torch.zeros_like(kb)
  dv = torch.zeros_like(vb)
  for part in range(3):
    w, ds = _probs_and_ds(qb, kb, vb, dob, lse_b, delta_b, mask_blocks, part,
                          scale, q.dtype)
    # Indexed by query block i, these belong to key block i + shift.
    shift = _SHIFTS[part]
    dv = dv + _shift(torch.einsum('bnhqk,bnqhd->bnkhd', _round(w, q.dtype),
                                  dob), -shift)
    dk = dk + _shift(torch.einsum('bnhqk,bnqhd->bnkhd', ds, qb), -shift)
  def out(x):
    return x.reshape(b, n, h, d).to(q.dtype)
  return out(dk * scale), out(dv)


def banded_attention_bwd_plain(q, k, v, o, lse, dout, mask_blocks,
                               block_size: int):
  """The whole plain backward: (dq, dk, dv) from the forward's o and lse."""
  delta = attention_delta(o, dout)
  dq = banded_attention_dq_plain(q, k, v, dout, lse, delta, mask_blocks,
                                 block_size)
  dk, dv = banded_attention_dkv_plain(q, k, v, dout, lse, delta, mask_blocks,
                                      block_size)
  return dq, dk, dv


def _check_cuda_operands(tensors, mask_blocks, block_size: int):
  """Raises unless the operands are what the kernels take; returns the
  library."""
  q = tensors['q']
  if q.dtype not in _DTYPE_CODES:
    raise TypeError(f'banded attention kernels take float32 or bfloat16, '
                    f'got {q.dtype}')
  for name, x in tensors.items():
    if not x.is_cuda or x.device != q.device:
      raise ValueError(f'{name} must be on {q.device}')
    if x.dtype != q.dtype or x.shape != q.shape:
      raise ValueError(f'{name}: {x.dtype} {tuple(x.shape)} does not match '
                       f'q: {q.dtype} {tuple(q.shape)}')
    if not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  _, n, _, d = q.shape
  if d not in _HEAD_DIMS:
    raise ValueError(f'head_dim {d} not in {_HEAD_DIMS}')
  bs = block_size
  if (mask_blocks.dtype != torch.uint8 or mask_blocks.dim() != 4
      or mask_blocks.shape[0] != 3 or tuple(mask_blocks.shape[2:]) != (bs, bs)
      or mask_blocks.shape[1] * bs != n):
    raise ValueError(f'mask_blocks must be uint8 [3, {n // bs}, {bs}, {bs}] '
                     f'for {n} nodes, got {mask_blocks.dtype} '
                     f'{tuple(mask_blocks.shape)}')
  if mask_blocks.device != q.device or not mask_blocks.is_contiguous():
    raise ValueError(f'mask_blocks must be contiguous on {q.device}')
  if bs % 8:
    raise ValueError(f'block_size {bs} is not a multiple of 8 (the kernels '
                     'read the mask 8 bytes at a time)')
  cuda_lib.check_aligned({name: x.data_ptr() for name, x in
                          {**tensors, 'mask_blocks': mask_blocks}.items()})
  return cuda_lib.library()


def _check_rows(lse, delta, q):
  b, n, h, _ = q.shape
  for name, x in (('lse', lse), ('delta', delta)):
    if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, n)
        or x.device != q.device or not x.is_contiguous()):
      raise ValueError(f'{name} must be contiguous float32 {(b, h, n)} on '
                       f'{q.device}')


def banded_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask_blocks: torch.Tensor,
                              block_size: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches kernel C: returns o [B, N, H, d] and lse [B, H, N] float32."""
  lib = _check_cuda_operands({'q': q, 'k': k, 'v': v}, mask_blocks,
                             block_size)
  b, n, h, d = q.shape
  o = torch.empty_like(q)
  lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  code = lib.gt_banded_attention_fwd(
      _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      mask_blocks.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, h,
      mask_blocks.shape[1], block_size, d ** -0.5, stream)
  cuda_lib.check(code, 'gt_banded_attention_fwd')
  KERNEL.launches += 1
  return o, lse


def banded_attention_dq_cuda(q, k, v, dout, lse, delta, mask_blocks,
                             block_size: int) -> torch.Tensor:
  """Launches kernel D's dq: returns dq [B, N, H, d]."""
  lib = _check_cuda_operands({'q': q, 'k': k, 'v': v, 'dout': dout},
                             mask_blocks, block_size)
  _check_rows(lse, delta, q)
  b, n, h, d = q.shape
  dq = torch.empty_like(q)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  code = lib.gt_banded_attention_bwd_dq(
      _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
      mask_blocks.data_ptr(), dq.data_ptr(), b, n, h, mask_blocks.shape[1],
      block_size, d ** -0.5, stream)
  cuda_lib.check(code, 'gt_banded_attention_bwd_dq')
  KERNEL_DQ.launches += 1
  return dq


def banded_attention_dkv_cuda(q, k, v, dout, lse, delta, mask_blocks,
                              block_size: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches kernel D's dk/dv: returns (dk, dv) [B, N, H, d]."""
  lib = _check_cuda_operands({'q': q, 'k': k, 'v': v, 'dout': dout},
                             mask_blocks, block_size)
  _check_rows(lse, delta, q)
  b, n, h, d = q.shape
  dk = torch.empty_like(q)
  dv = torch.empty_like(q)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  code = lib.gt_banded_attention_bwd_dkv(
      _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
      mask_blocks.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h,
      mask_blocks.shape[1], block_size, d ** -0.5, stream)
  cuda_lib.check(code, 'gt_banded_attention_bwd_dkv')
  KERNEL_DKV.launches += 1
  return dk, dv


class _BandedAttention(torch.autograd.Function):

  @staticmethod
  def forward(ctx, q, k, v, mask_blocks, block_size):
    if q.is_cuda:
      o, lse = banded_attention_fwd_cuda(q, k, v, mask_blocks, block_size)
    else:
      o, lse = banded_attention_plain(q, k, v, mask_blocks, block_size,
                                      return_lse=True)
    ctx.save_for_backward(q, k, v, o, lse, mask_blocks)
    ctx.block_size = block_size
    return o

  @staticmethod
  def backward(ctx, dout):
    q, k, v, o, lse, mask_blocks = ctx.saved_tensors
    bs = ctx.block_size
    dout = dout.to(q.dtype).contiguous()
    if not q.is_cuda:
      dq, dk, dv = banded_attention_bwd_plain(q, k, v, o, lse, dout,
                                              mask_blocks, bs)
    else:
      delta = attention_delta(o, dout)
      dq = banded_attention_dq_cuda(q, k, v, dout, lse, delta, mask_blocks,
                                    bs)
      dk, dv = banded_attention_dkv_cuda(q, k, v, dout, lse, delta,
                                         mask_blocks, bs)
    return dq, dk, dv, None, None


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_blocks: torch.Tensor, block_size: int
                     ) -> torch.Tensor:
  """Tri-block attention; q/k/v [B, N, H, d] with N = nb * block_size ->
  [B, N, H, d]. Kernels C (forward) and D (backward) on a CUDA tensor, the
  plain versions on a CPU tensor."""
  return _BandedAttention.apply(q, k, v, mask_blocks, block_size)
