"""Block-sparse attention over the k-hop mesh mask (kernel A).

`sparse_banded_attention` computes, for q/k/v [B, N, H, d], the softmax
attention of every query node over the key nodes its k-hop mask allows,
using a `graph.plans.TilePlan`: per query tile, the list of key/value tiles
with any allowed pair and the exact uint8 mask tile of each pair. Rows that
see no allowed key (padding) give exactly 0, as in the reference
(`gencast_tpu.ops.sparse_attention`).

* On a CUDA tensor it launches the hand-written kernel
  `csrc/sparse_attention.cu` (or raises); the kernel also writes the row
  log-sum-exp for a later backward pass.
* On a CPU tensor it runs `sparse_banded_attention_plain`, the plain
  PyTorch version of the same function: gather each query tile's active
  key/value/mask tiles and take a masked softmax in float32.

Serving needs only the forward; the backward kernels of the reference (its
_dq_kernel, _dkv_kernel and fused _dkvq_kernel) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gencast_tpu_torch.ops import cuda_lib

NEG_INF = -1e30

KERNEL = cuda_lib.KernelCounter(
    'sparse_attention_fwd', 'gencast_tpu_torch/csrc/sparse_attention.cu',
    'gencast_tpu/ops/sparse_attention.py:231')

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernel is compiled for: TINY (32) and ONE_DEG (128).
_HEAD_DIMS = (32, 128)

# The plain version takes this many query tiles at a time: its gathered
# [B, chunk, A, tile, H, d] float32 key/value copies grow with the chunk,
# and 16 keeps them near 0.17 GB each at the 1-degree size (tile 64, A = 83,
# H = 4, d = 128).
_Q_TILES_PER_CHUNK = 16


def sparse_banded_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, mask_tiles: torch.Tensor,
                                  fwd_ids: torch.Tensor,
                                  fwd_pids: torch.Tensor, tile: int
                                  ) -> torch.Tensor:
  """Plain PyTorch version: q/k/v [B, N, H, d] -> [B, N, H, d].

  Computes in float32 and returns the input dtype.
  """
  b, n, h, d = q.shape
  nq = fwd_ids.shape[0]
  padded = nq * tile
  if padded < n:
    raise ValueError(f'plan covers {padded} nodes, inputs have {n}')

  def tiles(x):
    x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, padded - n))
    return x.view(b, nq, tile, h, d)

  qt, kt, vt = tiles(q), tiles(k), tiles(v)
  out = torch.empty(b, nq, tile, h, d, dtype=torch.float32, device=q.device)
  scale = d ** -0.5
  for start in range(0, nq, _Q_TILES_PER_CHUNK):
    sl = slice(start, min(nq, start + _Q_TILES_PER_CHUNK))
    ids = fwd_ids[sl].long()                             # [c, A]
    allowed = mask_tiles[fwd_pids[sl].long()] != 0       # [c, A, t, t]
    allowed = allowed.permute(0, 2, 1, 3)[None, :, None]  # [1, c, 1, i, A, j]
    logits = torch.einsum('bcihd,bcajhd->bchiaj', qt[:, sl], kt[:, ids])
    logits = (logits * scale).masked_fill(~allowed, NEG_INF)
    m = logits.amax(dim=(-2, -1), keepdim=True)
    p = torch.where(allowed, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=(-2, -1)).clamp_min(1e-30)         # [B, c, H, i]
    o = torch.einsum('bchiaj,bcajhd->bcihd', p, vt[:, ids])
    out[:, sl] = o / denom.permute(0, 1, 3, 2)[..., None]
  return out.view(b, padded, h, d)[:, :n].to(q.dtype)


def sparse_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask_tiles: torch.Tensor,
                              fwd_ids: torch.Tensor, fwd_pids: torch.Tensor,
                              tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches kernel A: returns o [B, N, H, d] and lse [B, H, N] float32."""
  if q.dtype not in _DTYPE_CODES:
    raise TypeError(f'sparse attention kernel takes float32 or bfloat16, '
                    f'got {q.dtype}')
  for name, x in (('q', q), ('k', k), ('v', v)):
    if not x.is_cuda or x.device != q.device:
      raise ValueError(f'{name} must be on {q.device}')
    if x.dtype != q.dtype or x.shape != q.shape:
      raise ValueError(f'{name}: {x.dtype} {tuple(x.shape)} does not match '
                       f'q: {q.dtype} {tuple(q.shape)}')
    if not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  b, n, h, d = q.shape
  lib = cuda_lib.library()
  kernel_tile = lib.gt_sparse_attention_tile()
  if tile != kernel_tile:
    raise ValueError(f'the kernel is built for tile {kernel_tile}, '
                     f'plan tile is {tile}')
  if d not in _HEAD_DIMS:
    raise ValueError(f'head_dim {d} not in {_HEAD_DIMS}')
  nq, num_active = fwd_ids.shape
  if nq * tile < n:
    raise ValueError(f'plan covers {nq * tile} nodes, inputs have {n}')
  if (mask_tiles.dtype != torch.uint8 or mask_tiles.dim() != 3
      or tuple(mask_tiles.shape[1:]) != (tile, tile)):
    raise ValueError('mask_tiles must be uint8 [P + 1, tile, tile]')
  for name, x in (('mask_tiles', mask_tiles), ('fwd_ids', fwd_ids),
                  ('fwd_pids', fwd_pids)):
    if x.device != q.device or not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous on {q.device}')
  if fwd_ids.dtype != torch.int32 or fwd_pids.dtype != torch.int32 or \
      fwd_pids.shape != fwd_ids.shape:
    raise ValueError('fwd_ids / fwd_pids must be int32 [nq, A]')

  o = torch.empty_like(q)
  lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  code = lib.gt_sparse_attention_fwd(
      _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      mask_tiles.data_ptr(), fwd_ids.data_ptr(), fwd_pids.data_ptr(),
      o.data_ptr(), lse.data_ptr(), b, n, h, nq, num_active,
      mask_tiles.shape[0] - 1, d ** -0.5, stream)
  cuda_lib.check(code, 'gt_sparse_attention_fwd')
  KERNEL.launches += 1
  return o, lse


def sparse_banded_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask_tiles: torch.Tensor,
                            fwd_ids: torch.Tensor, fwd_pids: torch.Tensor,
                            tile: int) -> torch.Tensor:
  """Block-sparse attention; q/k/v [B, N, H, d] -> [B, N, H, d].

  Kernel A on a CUDA tensor, the plain version on a CPU tensor.
  """
  if not q.is_cuda:
    return sparse_banded_attention_plain(q, k, v, mask_tiles, fwd_ids,
                                         fwd_pids, tile)
  o, _ = sparse_attention_fwd_cuda(q, k, v, mask_tiles, fwd_ids, fwd_pids,
                                   tile)
  return o
