"""Block-sparse attention over the k-hop mesh mask (kernels A, F and G).

`sparse_banded_attention` computes, for q/k/v [B, N, H, d], the softmax
attention of every query node over the key nodes its k-hop mask allows,
using a `graph.plans.TilePlan`: per query tile, the list of key/value tiles
with any allowed pair and the exact uint8 mask tile of each pair. Rows that
see no allowed key (padding) give exactly 0, as in the reference
(`gencast_tpu.ops.sparse_attention`).

It is a `torch.autograd.Function` whose backward follows the reference's
`_sba_bwd`: from the forward's saved row log-sum-exp and
delta = rowsum(dO * O) (float32, computed outside the kernels), dq over the
forward plan and dk/dv over the reverse plan (`bwd_q_ids`/`bwd_pair_ids`).
Given the fused backward's gather map as well (`slot_ids`, `valid` from
`graph.plans.build_bwd_gather`), it runs the reference's opt-in
`_sba_bwd_fused` instead, as the reference does when its VJP gets four
backward arrays: one sweep of the reverse plan gives dk, dv and each pair's
dq partial ds . K rounded to the input dtype, and `sparse_attention_dq_reduce`
sums each q tile's partials in float32 and scales them.

* On a CUDA tensor it launches the hand-written kernels: the forward
  `csrc/sparse_attention.cu` (kernel A, which also writes the lse) and the
  backward `csrc/sparse_attention_bwd.cu` (kernel F: dq, then dk/dv; or
  kernel G, the fused sweep), or raises.
* On a CPU tensor it runs the plain PyTorch versions of the same functions
  (`sparse_banded_attention_plain`, `sparse_attention_dq_plain`,
  `sparse_attention_dkv_plain`, `sparse_attention_dkvq_plain`): gather each
  tile's active tiles and do the masked arithmetic explicitly, a chunk of
  tiles at a time, in float32 (or float64 for float64 inputs). The backward
  never materializes more than a chunk's probabilities.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gencast_tpu_torch.ops import cuda_lib

NEG_INF = -1e30

KERNEL = cuda_lib.KernelCounter(
    'sparse_attention_fwd', 'gencast_tpu_torch/csrc/sparse_attention.cu',
    'gencast_tpu/ops/sparse_attention.py:231')
KERNEL_DQ = cuda_lib.KernelCounter(
    'sparse_attention_bwd_dq',
    'gencast_tpu_torch/csrc/sparse_attention_bwd.cu',
    'gencast_tpu/ops/sparse_attention.py:277')
KERNEL_DKV = cuda_lib.KernelCounter(
    'sparse_attention_bwd_dkv',
    'gencast_tpu_torch/csrc/sparse_attention_bwd.cu',
    'gencast_tpu/ops/sparse_attention.py:314')
KERNEL_DKVQ = cuda_lib.KernelCounter(
    'sparse_attention_bwd_dkvq',
    'gencast_tpu_torch/csrc/sparse_attention_bwd.cu',
    'gencast_tpu/ops/sparse_attention.py:354')

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernels are compiled for: TINY (32) and ONE_DEG (128).
_HEAD_DIMS = (32, 128)

# The plain versions take this many tiles at a time: their gathered
# [B, chunk, A, tile, H, d] float32 key/value copies grow with the chunk,
# and 16 keeps them near 0.17 GB each at the 1-degree size (tile 64, A = 83,
# H = 4, d = 128).
_TILES_PER_CHUNK = 16


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
  return torch.promote_types(dtype, torch.float32)


def _tiles(x: torch.Tensor, nt: int, tile: int, acc: torch.dtype
           ) -> torch.Tensor:
  """[B, N, H, d] -> [B, nt, tile, H, d] in `acc`, zero-padded."""
  b, n, h, d = x.shape
  x = torch.nn.functional.pad(x.to(acc), (0, 0, 0, 0, 0, nt * tile - n))
  return x.view(b, nt, tile, h, d)


def _row_tiles(x: torch.Tensor, nt: int, tile: int, acc: torch.dtype
               ) -> torch.Tensor:
  """[B, H, N] -> [B, nt, H, tile] in `acc`, zero-padded."""
  b, h, n = x.shape
  x = torch.nn.functional.pad(x.to(acc), (0, nt * tile - n))
  return x.view(b, h, nt, tile).transpose(1, 2)


def _chunks(num_tiles: int):
  for start in range(0, num_tiles, _TILES_PER_CHUNK):
    yield slice(start, min(num_tiles, start + _TILES_PER_CHUNK))


def sparse_banded_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, mask_tiles: torch.Tensor,
                                  fwd_ids: torch.Tensor,
                                  fwd_pids: torch.Tensor, tile: int,
                                  return_lse: bool = False):
  """Plain PyTorch version of kernel A: q/k/v [B, N, H, d] -> [B, N, H, d]
  in the input dtype, and with return_lse also the row log-sum-exp
  [B, H, N] (float32, float64 for float64 inputs; ~-1e30 on rows that see
  no key). Computes in float32 (float64)."""
  b, n, h, d = q.shape
  nq = fwd_ids.shape[0]
  padded = nq * tile
  if padded < n:
    raise ValueError(f'plan covers {padded} nodes, inputs have {n}')
  acc = _acc_dtype(q.dtype)
  qt, kt, vt = (_tiles(x, nq, tile, acc) for x in (q, k, v))
  out = torch.empty(b, nq, tile, h, d, dtype=acc, device=q.device)
  lse = torch.empty(b, nq, h, tile, dtype=acc, device=q.device)
  scale = d ** -0.5
  for sl in _chunks(nq):
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
    lse[:, sl] = m[..., 0, 0] + torch.log(denom)
  out = out.view(b, padded, h, d)[:, :n].to(q.dtype)
  if not return_lse:
    return out
  return out, lse.transpose(1, 2).reshape(b, h, padded)[:, :, :n]


def attention_delta(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
  """delta = rowsum(dO * O): [B, N, H, d] -> [B, H, N] float32 (float64
  for float64 inputs), as the reference computes it outside its kernels."""
  acc = _acc_dtype(o.dtype)
  return (dout.to(acc) * o.to(acc)).sum(dim=-1).transpose(1, 2).contiguous()


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """x rounded to `dtype` and widened back: the value of a matmul operand
  the reference casts to the input dtype."""
  return x.to(dtype).to(x.dtype)


def sparse_attention_dq_plain(q, k, v, dout, lse, delta, mask_tiles,
                              fwd_ids, fwd_pids, tile: int) -> torch.Tensor:
  """Plain PyTorch version of kernel F's dq: over the forward plan,
  w = where(mask, exp(s * scale - lse), 0), ds = w * (dO . V^T - delta),
  dq = scale * ds . K, with ds rounded to the input dtype before its
  product. q/k/v/dout [B, N, H, d], lse/delta [B, H, N] -> dq [B, N, H, d]
  in the input dtype."""
  b, n, h, d = q.shape
  nq = fwd_ids.shape[0]
  acc = _acc_dtype(q.dtype)
  qt, kt, vt, dot = (_tiles(x, nq, tile, acc) for x in (q, k, v, dout))
  lse_t, delta_t = (_row_tiles(x, nq, tile, acc) for x in (lse, delta))
  dq = torch.empty(b, nq, tile, h, d, dtype=acc, device=q.device)
  scale = d ** -0.5
  for sl in _chunks(nq):
    ids = fwd_ids[sl].long()
    allowed = mask_tiles[fwd_pids[sl].long()] != 0
    allowed = allowed.permute(0, 2, 1, 3)[None, :, None]  # [1, c, 1, i, A, j]
    s = torch.einsum('bcihd,bcajhd->bchiaj', qt[:, sl], kt[:, ids]) * scale
    w = torch.where(allowed, torch.exp(s - lse_t[:, sl, :, :, None, None]),
                    0.0)
    dp = torch.einsum('bcihd,bcajhd->bchiaj', dot[:, sl], vt[:, ids])
    ds = _round(w * (dp - delta_t[:, sl, :, :, None, None]), q.dtype)
    dq[:, sl] = torch.einsum('bchiaj,bcajhd->bcihd', ds, kt[:, ids]) * scale
  return dq.view(b, nq * tile, h, d)[:, :n].to(q.dtype)


def _reverse_sweep_plain(q, k, v, dout, lse, delta, mask_tiles, bwd_ids,
                         bwd_pids, tile: int, partials: bool):
  """The reverse-plan sweep of kernels F (dk/dv) and G: (dk, dv, and with
  `partials` the [B, nk * A, H, tile, d] dq partials, else None)."""
  b, n, h, d = q.shape
  nk, num_active = bwd_ids.shape
  acc = _acc_dtype(q.dtype)
  qt, kt, vt, dot = (_tiles(x, nk, tile, acc) for x in (q, k, v, dout))
  lse_t, delta_t = (_row_tiles(x, nk, tile, acc) for x in (lse, delta))
  dk = torch.empty(b, nk, tile, h, d, dtype=acc, device=q.device)
  dv = torch.empty_like(dk)
  partial = (torch.empty(b, nk, num_active, h, tile, d, dtype=q.dtype,
                         device=q.device) if partials else None)
  scale = d ** -0.5
  for sl in _chunks(nk):
    ids = bwd_ids[sl].long()                              # q tiles [c, A]
    # Mask tiles are [q row i, kv col j]; here kv rows lead.
    allowed = mask_tiles[bwd_pids[sl].long()] != 0        # [c, A, i, j]
    allowed = allowed.permute(0, 3, 1, 2)[None, :, None]  # [1, c, 1, j, A, i]
    s = torch.einsum('bcjhd,bcaihd->bchjai', kt[:, sl], qt[:, ids]) * scale
    lse_g = lse_t[:, ids].permute(0, 1, 3, 2, 4)[:, :, :, None]
    delta_g = delta_t[:, ids].permute(0, 1, 3, 2, 4)[:, :, :, None]
    w = torch.where(allowed, torch.exp(s - lse_g), 0.0)   # [B, c, H, j, A, i]
    dp = torch.einsum('bcjhd,bcaihd->bchjai', vt[:, sl], dot[:, ids])
    ds = _round(w * (dp - delta_g), q.dtype)
    dv[:, sl] = torch.einsum('bchjai,bcaihd->bcjhd', _round(w, q.dtype),
                             dot[:, ids])
    dk[:, sl] = torch.einsum('bchjai,bcaihd->bcjhd', ds, qt[:, ids]) * scale
    if partials:
      # Each pair's own ds . K, rounded to the input dtype (pad pairs give
      # exact zeros: their mask tile is empty).
      partial[:, sl] = torch.einsum('bchjai,bcjhd->bcahid', ds,
                                    kt[:, sl]).to(q.dtype)
  def out(x):
    return x.view(b, nk * tile, h, d)[:, :n].to(q.dtype)
  if partials:
    partial = partial.view(b, nk * num_active, h, tile, d)
  return out(dk), out(dv), partial


def sparse_attention_dkv_plain(q, k, v, dout, lse, delta, mask_tiles,
                               bwd_ids, bwd_pids, tile: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of kernel F's dk/dv: over the reverse plan (per
  kv tile, the q tiles that touch it), dv = w^T . dO and
  dk = scale * ds^T . Q, with w and ds rounded to the input dtype before
  their products. Returns (dk, dv) [B, N, H, d] in the input dtype."""
  dk, dv, _ = _reverse_sweep_plain(q, k, v, dout, lse, delta, mask_tiles,
                                   bwd_ids, bwd_pids, tile, partials=False)
  return dk, dv


def sparse_attention_dkvq_plain(q, k, v, dout, lse, delta, mask_tiles,
                                bwd_ids, bwd_pids, tile: int
                                ) -> Tuple[torch.Tensor, ...]:
  """Plain PyTorch version of kernel G, the fused backward sweep: kernel F's
  dk and dv over the reverse plan, and for every reverse pair (kv tile kj,
  slot a) its dq partial ds . K (unscaled, rounded to the input dtype) at
  slot kj * A + a of partial [B, nk * A, H, tile, d]. Returns (dk, dv,
  partial); `sparse_attention_dq_reduce` turns the partials into dq."""
  return _reverse_sweep_plain(q, k, v, dout, lse, delta, mask_tiles, bwd_ids,
                              bwd_pids, tile, partials=True)


def sparse_attention_dq_reduce(partial: torch.Tensor, slot_ids: torch.Tensor,
                               valid: torch.Tensor, n: int) -> torch.Tensor:
  """dq of the fused backward: for q tile qi,
  scale * sum_a valid[qi, a] * partial[:, slot_ids[qi, a]], summed in
  float32 (float64 for float64 partials) and cast to the partials' dtype,
  as the reference's gather-reduce. partial [B, S, H, tile, d]; slot_ids,
  valid [nq, A] (`graph.plans.build_bwd_gather`) -> dq [B, n, H, d].

  Entries with valid 0 are selected away, not multiplied by 0, so slots
  that kernel G leaves unwritten (pad pairs) never reach the sum. The
  gather runs a chunk of q tiles at a time.
  """
  b, _, h, tile, d = partial.shape
  nq, num_active = slot_ids.shape
  acc = _acc_dtype(partial.dtype)
  keep = (valid != 0)[None, :, :, None, None, None]
  dq = torch.empty(b, nq, tile, h, d, dtype=partial.dtype,
                   device=partial.device)
  for sl in _chunks(nq):
    c = sl.stop - sl.start
    g = partial.index_select(1, slot_ids[sl].reshape(-1).long())
    g = torch.where(keep[:, sl], g.view(b, c, num_active, h, tile, d), 0)
    dq[:, sl] = (g.sum(dim=2, dtype=acc) * d ** -0.5).to(
        partial.dtype).transpose(2, 3)
  return dq.view(b, nq * tile, h, d)[:, :n]


def sparse_attention_bwd_plain(q, k, v, o, lse, dout, mask_tiles, fwd_ids,
                               fwd_pids, bwd_ids, bwd_pids, tile: int):
  """The whole plain backward: (dq, dk, dv) from the forward's o and lse."""
  delta = attention_delta(o, dout)
  dq = sparse_attention_dq_plain(q, k, v, dout, lse, delta, mask_tiles,
                                 fwd_ids, fwd_pids, tile)
  dk, dv = sparse_attention_dkv_plain(q, k, v, dout, lse, delta, mask_tiles,
                                      bwd_ids, bwd_pids, tile)
  return dq, dk, dv


def _check_cuda_operands(tensors, mask_tiles, ids, pids, tile: int):
  """Raises unless the operands are what the kernels take; returns the
  library."""
  q = tensors['q']
  if q.dtype not in _DTYPE_CODES:
    raise TypeError(f'sparse attention kernels take float32 or bfloat16, '
                    f'got {q.dtype}')
  for name, x in tensors.items():
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
    raise ValueError(f'the kernels are built for tile {kernel_tile}, '
                     f'plan tile is {tile}')
  if d not in _HEAD_DIMS:
    raise ValueError(f'head_dim {d} not in {_HEAD_DIMS}')
  if ids.shape[0] * tile < n:
    raise ValueError(f'plan covers {ids.shape[0] * tile} nodes, inputs '
                     f'have {n}')
  if (mask_tiles.dtype != torch.uint8 or mask_tiles.dim() != 3
      or tuple(mask_tiles.shape[1:]) != (tile, tile)):
    raise ValueError('mask_tiles must be uint8 [P + 1, tile, tile]')
  for name, x in (('mask_tiles', mask_tiles), ('ids', ids), ('pids', pids)):
    if x.device != q.device or not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous on {q.device}')
  if ids.dtype != torch.int32 or pids.dtype != torch.int32 or \
      pids.shape != ids.shape or ids.dim() != 2:
    raise ValueError('plan ids / pair ids must be int32 [tiles, A]')
  cuda_lib.check_aligned({name: x.data_ptr() for name, x in
                          {**tensors, 'mask_tiles': mask_tiles}.items()})
  return lib


def _check_rows(lse, delta, q):
  b, n, h, _ = q.shape
  for name, x in (('lse', lse), ('delta', delta)):
    if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, n)
        or x.device != q.device or not x.is_contiguous()):
      raise ValueError(f'{name} must be contiguous float32 {(b, h, n)} on '
                       f'{q.device}')


def sparse_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask_tiles: torch.Tensor,
                              fwd_ids: torch.Tensor, fwd_pids: torch.Tensor,
                              tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches kernel A: returns o [B, N, H, d] and lse [B, H, N] float32."""
  lib = _check_cuda_operands({'q': q, 'k': k, 'v': v}, mask_tiles, fwd_ids,
                             fwd_pids, tile)
  b, n, h, d = q.shape
  nq, num_active = fwd_ids.shape
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


def sparse_attention_dq_cuda(q, k, v, dout, lse, delta, mask_tiles, fwd_ids,
                             fwd_pids, tile: int) -> torch.Tensor:
  """Launches kernel F's dq over the forward plan: returns dq
  [B, N, H, d]."""
  lib = _check_cuda_operands({'q': q, 'k': k, 'v': v, 'dout': dout},
                             mask_tiles, fwd_ids, fwd_pids, tile)
  _check_rows(lse, delta, q)
  b, n, h, d = q.shape
  nq, num_active = fwd_ids.shape
  dq = torch.empty_like(q)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  code = lib.gt_sparse_attention_bwd_dq(
      _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
      mask_tiles.data_ptr(), fwd_ids.data_ptr(), fwd_pids.data_ptr(),
      dq.data_ptr(), b, n, h, nq, num_active, mask_tiles.shape[0] - 1,
      d ** -0.5, stream)
  cuda_lib.check(code, 'gt_sparse_attention_bwd_dq')
  KERNEL_DQ.launches += 1
  return dq


def sparse_attention_dkv_cuda(q, k, v, dout, lse, delta, mask_tiles, bwd_ids,
                              bwd_pids, tile: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launches kernel F's dk/dv over the reverse plan: returns (dk, dv)
  [B, N, H, d]."""
  lib = _check_cuda_operands({'q': q, 'k': k, 'v': v, 'dout': dout},
                             mask_tiles, bwd_ids, bwd_pids, tile)
  _check_rows(lse, delta, q)
  b, n, h, d = q.shape
  nk, num_active = bwd_ids.shape
  dk = torch.empty_like(q)
  dv = torch.empty_like(q)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  code = lib.gt_sparse_attention_bwd_dkv(
      _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
      mask_tiles.data_ptr(), bwd_ids.data_ptr(), bwd_pids.data_ptr(),
      dk.data_ptr(), dv.data_ptr(), b, n, h, nk, num_active,
      mask_tiles.shape[0] - 1, d ** -0.5, stream)
  cuda_lib.check(code, 'gt_sparse_attention_bwd_dkv')
  KERNEL_DKV.launches += 1
  return dk, dv


def sparse_attention_dkvq_cuda(q, k, v, dout, lse, delta, mask_tiles,
                               bwd_ids, bwd_pids, tile: int
                               ) -> Tuple[torch.Tensor, ...]:
  """Launches kernel G over the reverse plan: returns (dk, dv) [B, N, H, d]
  and the dq partials [B, nk * A, H, tile, d] (pad slots left unwritten)."""
  lib = _check_cuda_operands({'q': q, 'k': k, 'v': v, 'dout': dout},
                             mask_tiles, bwd_ids, bwd_pids, tile)
  _check_rows(lse, delta, q)
  b, n, h, d = q.shape
  nk, num_active = bwd_ids.shape
  dk = torch.empty_like(q)
  dv = torch.empty_like(q)
  partial = torch.empty(b, nk * num_active, h, tile, d, dtype=q.dtype,
                        device=q.device)
  stream = torch.cuda.current_stream(q.device).cuda_stream
  code = lib.gt_sparse_attention_bwd_dkvq(
      _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
      mask_tiles.data_ptr(), bwd_ids.data_ptr(), bwd_pids.data_ptr(),
      dk.data_ptr(), dv.data_ptr(), partial.data_ptr(), b, n, h, nk,
      num_active, mask_tiles.shape[0] - 1, d ** -0.5, stream)
  cuda_lib.check(code, 'gt_sparse_attention_bwd_dkvq')
  KERNEL_DKVQ.launches += 1
  return dk, dv, partial


class _SparseAttention(torch.autograd.Function):

  @staticmethod
  def forward(ctx, q, k, v, mask_tiles, fwd_ids, fwd_pids, bwd_ids,
              bwd_pids, tile, slot_ids, valid):
    if q.is_cuda:
      o, lse = sparse_attention_fwd_cuda(q, k, v, mask_tiles, fwd_ids,
                                         fwd_pids, tile)
    else:
      o, lse = sparse_banded_attention_plain(q, k, v, mask_tiles, fwd_ids,
                                             fwd_pids, tile, return_lse=True)
    ctx.save_for_backward(q, k, v, o, lse, mask_tiles, fwd_ids, fwd_pids,
                          bwd_ids, bwd_pids, slot_ids, valid)
    ctx.tile = tile
    return o

  @staticmethod
  def backward(ctx, dout):
    (q, k, v, o, lse, mask_tiles, fwd_ids, fwd_pids, bwd_ids, bwd_pids,
     slot_ids, valid) = ctx.saved_tensors
    if bwd_ids is None:
      raise RuntimeError('sparse attention backward needs the reverse plan '
                         '(bwd_ids, bwd_pids)')
    dout = dout.to(q.dtype).contiguous()
    if slot_ids is not None:
      # The reference's fused backward (_sba_bwd_fused): kernel G.
      delta = attention_delta(o, dout)
      dkvq = (sparse_attention_dkvq_cuda if q.is_cuda
              else sparse_attention_dkvq_plain)
      dk, dv, partial = dkvq(q, k, v, dout, lse, delta, mask_tiles, bwd_ids,
                             bwd_pids, ctx.tile)
      dq = sparse_attention_dq_reduce(partial, slot_ids, valid, q.shape[1])
    elif not q.is_cuda:
      dq, dk, dv = sparse_attention_bwd_plain(
          q, k, v, o, lse, dout, mask_tiles, fwd_ids, fwd_pids, bwd_ids,
          bwd_pids, ctx.tile)
    else:
      delta = attention_delta(o, dout)
      dq = sparse_attention_dq_cuda(q, k, v, dout, lse, delta, mask_tiles,
                                    fwd_ids, fwd_pids, ctx.tile)
      dk, dv = sparse_attention_dkv_cuda(q, k, v, dout, lse, delta,
                                         mask_tiles, bwd_ids, bwd_pids,
                                         ctx.tile)
    return dq, dk, dv, None, None, None, None, None, None, None, None


def sparse_banded_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask_tiles: torch.Tensor,
                            fwd_ids: torch.Tensor, fwd_pids: torch.Tensor,
                            tile: int, bwd_ids: Optional[torch.Tensor] = None,
                            bwd_pids: Optional[torch.Tensor] = None,
                            slot_ids: Optional[torch.Tensor] = None,
                            valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
  """Block-sparse attention; q/k/v [B, N, H, d] -> [B, N, H, d].

  Kernels A (forward) and F (backward) on a CUDA tensor, the plain versions
  on a CPU tensor. Differentiable when the reverse plan (bwd_ids,
  bwd_pids) is given; with the gather map of `graph.plans.build_bwd_gather`
  (slot_ids, valid) as well, the backward is the fused one, kernel G.
  """
  return _SparseAttention.apply(q, k, v, mask_tiles, fwd_ids, fwd_pids,
                                bwd_ids, bwd_pids, tile, slot_ids, valid)
