"""LayerNorm (no learned scale/bias) followed by FiLM, with its backward as
one kernel (kernel E).

Counterpart of `gencast_tpu.ops.ln_film`. `ln_film(x, scale, offset,
batch_axis)` takes rank-3 activations in the GNN's rows-leading [R, B, C]
layout (batch_axis=1) or the transformer's batch-leading [B, R, C]
(batch_axis=0), and scale/offset [B, C] (scale is the full multiplier, the
caller adds the +1 of FiLM's scale_minus_one).

* The forward is plain PyTorch in the op order the port always had
  (statistics in float32 with the one-pass variance clamped at 0, the
  normalized value cast back to x's dtype, the FiLM multiply in that dtype),
  so serving numbers do not move.
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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 8  # per block of the kernel, one row each at a time


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


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, dtype_code: int, c: int) -> int:
  sms = cuda_lib.sm_count(device_index)
  per_sm = cuda_lib.library().gt_ln_film_bwd_blocks_per_sm(dtype_code, c)
  if per_sm < 1:
    raise RuntimeError(f'gt_ln_film_bwd_blocks_per_sm({dtype_code}, {c}) '
                       f'returned {per_sm}')
  return sms * per_sm


def ln_film_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                     batch_axis: int, eps: float = EPS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Launches kernel E: returns (dx in x's dtype, dscale, doffset [B, C]
  float32)."""
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f'ln_film backward kernel takes float32 or bfloat16, '
                    f'got {x.dtype}')
  if x.dim() != 3 or batch_axis not in (0, 1):
    raise ValueError(f'x must be rank 3 with batch_axis 0 or 1, got '
                     f'{tuple(x.shape)}, {batch_axis}')
  b, c = x.shape[batch_axis], x.shape[2]
  rows = x.shape[1 - batch_axis]
  if c % 32 or not 32 <= c <= 1024:
    raise ValueError(f'channels must be a multiple of 32 in [32, 1024], '
                     f'got {c}')
  # The kernel reads and writes rows in 16-byte vectors.
  cuda_lib.check_aligned({'x': x.data_ptr(), 'dy': dy.data_ptr()})
  for name, t, shape in (('x', x, x.shape), ('dy', dy, x.shape),
                         ('scale', scale, (b, c))):
    if (not t.is_cuda or t.device != x.device or t.dtype != x.dtype
        or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
      raise ValueError(f'{name}: {t.dtype} {tuple(t.shape)} on {t.device} '
                       f'must be contiguous {x.dtype} {tuple(shape)} on '
                       f'{x.device}')
  row_stride, batch_stride = (c, rows * c) if batch_axis == 0 else (b * c, c)
  code_dtype = _DTYPE_CODES[x.dtype]
  blocks = launch_blocks(
      rows, b, _resident_blocks(x.device.index, code_dtype, c),
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
    return ln_film_forward(x, scale, offset, batch_axis)

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
  [B, C]. Differentiable in x, scale and offset through kernel E.
  """
  return _LnFilm.apply(x, scale, offset, batch_axis)
