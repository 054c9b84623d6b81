"""LayerNorm (no learned scale/bias) followed by FiLM, forward and backward
each one kernel on the card.

Counterpart of `gencast_tpu.ops.ln_film`. `ln_film(x, scale, offset,
batch_axis)` takes rank-3 activations in the GNN's rows-leading [R, B, C]
layout (batch_axis=1) or the transformer's batch-leading [B, R, C]
(batch_axis=0), and scale/offset [B, C] (scale is the full multiplier, the
caller adds the +1 of FiLM's scale_minus_one).

* The forward keeps the op order the port always had (statistics in
  float32 with the one-pass variance clamped at 0, the normalized value cast
  back to x's dtype, the FiLM multiply and add each rounded to that dtype),
  so serving numbers do not move. On a CUDA tensor it launches the
  hand-written kernel `csrc/ln_film_fwd.cu` (or raises), which reads x once
  and writes y once and differs from the plain version only in the float32
  summation order of the two means; on a CPU tensor it runs
  `ln_film_forward`, the plain PyTorch version.
* The backward gives dx and the row sums dscale = sum dy * x_hat and
  doffset = sum dy per batch element in float32. On a CUDA tensor it
  launches the hand-written kernel `csrc/ln_film_bwd.cu` (or raises), one
  cooperative launch per call whose grid the SM count sizes
  (`launch_blocks`); on a CPU tensor it runs `ln_film_bwd_plain`, the plain
  PyTorch version.

The reference's `ln_film._ln` does not clamp the variance; both compute the
same value wherever the one-pass variance is not negative.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from gencast_tpu_torch.ops import cuda_lib

EPS = 1e-6  # flax LayerNorm default, as in the reference.

KERNEL = cuda_lib.KernelCounter(
    'ln_film_bwd', 'gencast_tpu_torch/csrc/ln_film_bwd.cu',
    'gencast_tpu/ops/ln_film.py:74')
# The forward ports no Pallas kernel: the JAX package leaves it to XLA.
KERNEL_FWD = cuda_lib.KernelCounter(
    'ln_film_fwd', 'gencast_tpu_torch/csrc/ln_film_fwd.cu',
    'gencast_tpu/ops/ln_film.py:59')

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 8  # per block of either kernel, one row each at a time


def _mean_rstd(x: torch.Tensor, eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  # Fast variance E[x^2] - E[x]^2 from one pass, clipped at 0 (flax).
  mu = x.mean(dim=-1, keepdim=True)
  var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
  return mu, torch.rsqrt(var + eps)


def layer_norm_f32(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
  """(x - mean) * rstd over the last axis, in x's dtype (float32 or
  wider)."""
  mu, rstd = _mean_rstd(x, eps)
  return (x - mu) * rstd


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
  return torch.promote_types(dtype, torch.float32)


def _broadcast(v: torch.Tensor, batch_axis: int) -> torch.Tensor:
  """[B, C] -> [1, B, C] (batch_axis 1) or [B, 1, C] (batch_axis 0)."""
  return v[None] if batch_axis == 1 else v[:, None]


def ln_film_forward(x: torch.Tensor, scale: torch.Tensor,
                    offset: torch.Tensor, batch_axis: int) -> torch.Tensor:
  """LN statistics in float32, x_hat cast back to x's dtype, then
  x_hat * scale + offset with the operands' own dtype promotion."""
  x_hat = layer_norm_f32(x.to(_acc_dtype(x.dtype))).to(x.dtype)
  return x_hat * _broadcast(scale, batch_axis) + _broadcast(offset,
                                                            batch_axis)


def ln_film_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                      batch_axis: int, eps: float = EPS
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of kernel E: returns (dx in x's dtype, dscale and
  doffset [B, C] in float32, or float64 for float64 inputs)."""
  acc = _acc_dtype(x.dtype)
  x32, dy32 = x.to(acc), dy.to(acc)
  mu, rstd = _mean_rstd(x32, eps)
  x_hat = (x32 - mu) * rstd
  g = dy32 * _broadcast(scale.to(acc), batch_axis)
  dx = rstd * (g - g.mean(dim=-1, keepdim=True)
               - x_hat * (g * x_hat).mean(dim=-1, keepdim=True))
  row_axis = 1 - batch_axis
  return (dx.to(x.dtype), (dy32 * x_hat).sum(dim=row_axis),
          dy32.sum(dim=row_axis))


# Rows per warp that each further block per SM of kernel E's grid must
# keep: every block adds a partial row that the fold after the grid barrier
# reads, which at the mesh's 10,304 rows cost more than the rows' loads
# saved; and a grid that is not a whole number of blocks per SM leaves some
# SMs a block more to run.
_MIN_WARP_ROWS = 8


def launch_blocks(rows: int, batch: int, resident: int, sms: int) -> int:
  """Blocks per batch element of kernel E's cooperative grid: a whole
  number of blocks per SM, one more only while each warp keeps
  _MIN_WARP_ROWS rows, at most the `resident` blocks that fit on the card at
  once (SMs times blocks per SM) shared among the batch elements, and one
  warp per row at most."""
  if resident < batch:
    raise ValueError(f'{batch} batch elements need at least as many '
                     f'resident blocks, the card holds {resident}')
  per_sm = max(1, min(resident // sms,
                      rows * batch // (_WARPS * _MIN_WARP_ROWS * sms)))
  return max(1, min(sms * per_sm // batch, -(-rows // _WARPS)))


def warp_rows(rows: int, blocks: int) -> List[range]:
  """The rows each warp of one batch element's `blocks` blocks takes, as the
  kernel strides them: warp w of block k takes k * 8 + w, then every
  blocks * 8-th row."""
  stride = blocks * _WARPS
  return [range(k * _WARPS + w, rows, stride)
          for k in range(blocks) for w in range(_WARPS)]


# Waves of the forward kernel's grid: its blocks are this many times those
# that fit on the card at once. On an H100 six waves read 85-86% of the
# byte bound at the GNNs' shapes, one wave (a persistent grid) 80-81% and
# one row a warp 79-80%.
_FWD_WAVES = 6


def launch_blocks_fwd(rows: int, batch: int, resident: int) -> int:
  """Blocks per batch element of the forward kernel's grid: _FWD_WAVES
  times the `resident` blocks that fit on the card at once, shared among
  the batch elements (at least one each), and one warp per row at most.
  Its warps stride over the rows as kernel E's do (`warp_rows`)."""
  return max(1, min(_FWD_WAVES * resident // batch, -(-rows // _WARPS)))


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, query: str, dtype_code: int,
                     c: int) -> int:
  """SMs times the blocks of a kernel that fit on one (`query`, its C entry
  point)."""
  sms = cuda_lib.sm_count(device_index)
  per_sm = getattr(cuda_lib.library(), query)(dtype_code, c)
  if per_sm < 1:
    raise RuntimeError(f'{query}({dtype_code}, {c}) returned {per_sm}')
  return sms * per_sm


def _kernel_layout(x: torch.Tensor, batch_axis: int, like_x: dict,
                   per_batch: dict, aligned: Tuple[str, ...]
                   ) -> Tuple[int, int, int, int, int]:
  """The checks of both kernels' wrappers: x float32 or bfloat16 and rank 3
  with batch_axis 0 or 1, C a multiple of 32 in [32, 1024], the operands
  named in `aligned` starting on 16 bytes (the kernels load and store rows
  in 16-byte vectors), and x, `like_x` and `per_batch` ({name: tensor}) of
  x's dtype and contiguous CUDA tensors on x's device, of x's shape and of
  [B, C]. Returns (batch, rows, c, row stride, batch stride)."""
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f'ln_film kernels take float32 or bfloat16, got '
                    f'{x.dtype}')
  if x.dim() != 3 or batch_axis not in (0, 1):
    raise ValueError(f'x must be rank 3 with batch_axis 0 or 1, got '
                     f'{tuple(x.shape)}, {batch_axis}')
  b, c = x.shape[batch_axis], x.shape[2]
  rows = x.shape[1 - batch_axis]
  if c % 32 or not 32 <= c <= 1024:
    raise ValueError(f'channels must be a multiple of 32 in [32, 1024], '
                     f'got {c}')
  named = {'x': x, **like_x, **per_batch}
  for name, t in named.items():
    if t.dtype != x.dtype:
      raise ValueError(f'{name} is {t.dtype} and x {x.dtype}: the kernels '
                       'take one dtype')
  cuda_lib.check_aligned({n: named[n].data_ptr() for n in aligned})
  for name, t in named.items():
    shape = (b, c) if name in per_batch else tuple(x.shape)
    if (not t.is_cuda or t.device != x.device
        or tuple(t.shape) != shape or not t.is_contiguous()):
      raise ValueError(f'{name}: {t.dtype} {tuple(t.shape)} on {t.device} '
                       f'must be contiguous {x.dtype} {shape} on '
                       f'{x.device}')
  row_stride, batch_stride = (c, rows * c) if batch_axis == 0 else (b * c, c)
  return b, rows, c, row_stride, batch_stride


def ln_film_fwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                     offset: torch.Tensor, batch_axis: int,
                     eps: float = EPS) -> torch.Tensor:
  """Launches the forward kernel: y in x's dtype and layout."""
  b, rows, c, row_stride, batch_stride = _kernel_layout(
      x, batch_axis, {}, {'scale': scale, 'offset': offset},
      ('x', 'scale', 'offset'))
  code_dtype = _DTYPE_CODES[x.dtype]
  blocks = launch_blocks_fwd(rows, b, _resident_blocks(
      x.device.index, 'gt_ln_film_fwd_blocks_per_sm', code_dtype, c))
  y = torch.empty_like(x)
  code = cuda_lib.library().gt_ln_film_fwd(
      code_dtype, x.data_ptr(), scale.data_ptr(), offset.data_ptr(),
      y.data_ptr(), b, rows, c, row_stride, batch_stride, blocks, eps,
      torch.cuda.current_stream(x.device).cuda_stream)
  cuda_lib.check(code, 'gt_ln_film_fwd')
  KERNEL_FWD.launches += 1
  return y


def ln_film_fwd(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                batch_axis: int) -> torch.Tensor:
  """The forward kernel on a CUDA tensor, the plain version on a CPU
  tensor."""
  if not x.is_cuda:
    return ln_film_forward(x, scale, offset, batch_axis)
  return ln_film_fwd_cuda(x.contiguous(), scale.contiguous(),
                          offset.contiguous(), batch_axis)


def ln_film_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                     batch_axis: int, eps: float = EPS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Launches kernel E: returns (dx in x's dtype, dscale, doffset [B, C]
  float32)."""
  b, rows, c, row_stride, batch_stride = _kernel_layout(
      x, batch_axis, {'dy': dy}, {'scale': scale}, ('x', 'dy'))
  code_dtype = _DTYPE_CODES[x.dtype]
  blocks = launch_blocks(
      rows, b, _resident_blocks(x.device.index,
                                'gt_ln_film_bwd_blocks_per_sm', code_dtype,
                                c),
      cuda_lib.sm_count(x.device.index))
  dx = torch.empty_like(x)
  parts = torch.empty(b * blocks, 2, c, dtype=torch.float32,
                      device=x.device)
  sums = torch.empty(2, b, c, dtype=torch.float32, device=x.device)
  lib = cuda_lib.library()
  stream = torch.cuda.current_stream(x.device).cuda_stream
  code = lib.gt_ln_film_bwd(
      code_dtype, x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
      dx.data_ptr(), parts.data_ptr(), sums[0].data_ptr(),
      sums[1].data_ptr(), b, rows, c, row_stride, batch_stride, blocks, eps,
      stream)
  cuda_lib.check(code, 'gt_ln_film_bwd')
  KERNEL.launches += 1
  return dx, sums[0], sums[1]


def ln_film_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                batch_axis: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Kernel E on a CUDA tensor, the plain version on a CPU tensor."""
  if not x.is_cuda:
    return ln_film_bwd_plain(x, dy, scale, batch_axis)
  return ln_film_bwd_cuda(x.contiguous(), dy.contiguous(), scale.contiguous(),
                          batch_axis)


class _LnFilm(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, scale, offset, batch_axis):
    ctx.save_for_backward(x, scale)
    ctx.batch_axis = batch_axis
    return ln_film_fwd(x, scale, offset, batch_axis)

  @staticmethod
  def backward(ctx, dy):
    x, scale = ctx.saved_tensors
    # The forward multiplies in the promoted dtype of x_hat and scale; the
    # kernel takes x's dtype throughout (the two agree on every path of the
    # model, where activations and conditioning share one dtype).
    dx, dscale, doffset = ln_film_bwd(x, dy.to(x.dtype), scale.to(x.dtype),
                                      ctx.batch_axis)
    return dx, dscale.to(scale.dtype), doffset.to(scale.dtype), None


def ln_film(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
            batch_axis: int) -> torch.Tensor:
  """LayerNorm (no learned scale/bias) then x_hat * scale + offset.

  x: [R, B, C] (batch_axis=1) or [B, R, C] (batch_axis=0); scale, offset:
  [B, C]. On the card the forward kernel computes it, and kernel E its
  gradient in x, scale and offset.
  """
  return _LnFilm.apply(x, scale, offset, batch_axis)
