"""Edge -> node aggregation over static edge lists (kernel B).

Counterpart of `gencast_tpu.ops.segment`. Three strategies, as there:

1. Uniform degree: mesh2grid edges are receiver-sorted with exactly 3
   senders per grid node, so the sum is a dense reshape + sum (and the
   receiver gather a broadcast).
2. Planned sum (`segment_sum_planned`) over a `graph.plans.AggPlan`, for the
   skewed mesh-side degree distributions: on a CUDA tensor the
   hand-written CSR row reduction `csrc/segment_sum.cu`, which reads float32
   or bf16 edges and sums in float32, on a CPU tensor
   `planned_segment_sum_plain` (an index_add_ in float32).
3. Plain `index_add_` for everything else, on the CPU only: on the card it
   adds atomically, in an order that changes from run to run
   (`adds_atomically`), so there `nn.gnn` gives every side of non-uniform
   degree a plan.

Neither direction scatters, as in the reference: the backward of
`segment_sum_planned` is a gather at the segment ids, and `gather_planned`
(a gather over an edge side that carries a plan) has the planned sum as its
backward, accumulated in float32 when the cotangent is bf16.
"""

from __future__ import annotations

from typing import Optional

import torch

from gencast_tpu_torch.ops import cuda_lib

KERNEL = cuda_lib.KernelCounter(
    'segment_sum', 'gencast_tpu_torch/csrc/segment_sum.cu',
    'gencast_tpu/ops/segment.py:189')

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Rows of more edges than this are summed by all 8 warps of the kernel's
# block, an eighth each, the eighths added in order (other bits than the
# stored-order sum, the same from run to run); shorter rows by one warp in
# stored order.
SPLIT_DEGREE = 64


def adds_atomically(x: torch.Tensor) -> bool:
  """Whether `index_add_` into a tensor like `x`, and so the backward of
  `index_select` from it, adds with atomics (on a CUDA device): the sums'
  order, and with it their last bits, then change from run to run."""
  return x.is_cuda


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, f32_accumulate: bool = False,
                       normalization: Optional[float] = None,
                       uniform_k: Optional[int] = None) -> torch.Tensor:
  """Sum of `data` rows [E, ...] per receiver segment -> [num_segments, ...].

  uniform_k, when the ids are repeat(arange(num_segments), k) (see
  graph.plans.uniform_degree), takes the dense reshape-sum. f32_accumulate
  upcasts the messages to float32 for the reduction and casts back (the
  reference's f32_aggregation).
  """
  dtype = data.dtype
  if f32_accumulate:
    data = data.float()
  if uniform_k is not None:
    out = data.reshape((num_segments, uniform_k) + data.shape[1:]).sum(dim=1)
  else:
    out = data.new_zeros((num_segments,) + data.shape[1:]).index_add_(
        0, segment_ids, data)
  if normalization is not None:
    out = out / normalization
  return out.to(dtype)


def gather(nodes: torch.Tensor, indices: torch.Tensor,
           uniform_k: Optional[int] = None) -> torch.Tensor:
  """nodes[indices] along the leading axis; [N, ...] -> [E, ...]. With
  uniform_k (indices == repeat(arange(N), k)) a broadcast, not a gather."""
  if uniform_k is not None:
    n = nodes.shape[0]
    return nodes.unsqueeze(1).expand((n, uniform_k) + nodes.shape[1:]) \
        .reshape((n * uniform_k,) + nodes.shape[1:])
  return nodes.index_select(0, indices)


def planned_segment_sum_plain(data: torch.Tensor, row_ptr: torch.Tensor,
                              perm: Optional[torch.Tensor]) -> torch.Tensor:
  """Plain PyTorch version of kernel B: [E, F] -> [N, F], float32 sums."""
  n = row_ptr.shape[0] - 1
  e = data.shape[0]
  src = data if perm is None else data.index_select(0, perm.long())
  counts = (row_ptr[1:] - row_ptr[:-1]).long()
  seg = torch.repeat_interleave(
      torch.arange(n, device=data.device), counts, output_size=e)
  out = torch.zeros(n, data.shape[1], dtype=torch.float32, device=data.device)
  return out.index_add_(0, seg, src.float()).to(data.dtype)


def planned_segment_sum_cuda(data: torch.Tensor, row_ptr: torch.Tensor,
                             perm: Optional[torch.Tensor],
                             split_degree: int = SPLIT_DEGREE
                             ) -> torch.Tensor:
  """Launches kernel B: data [E, F] float32 or bf16 -> [N, F] float32 (bf16
  rows are widened in the kernel: the sums are those of the exact float32
  upcast)."""
  if data.dtype not in _DTYPE_CODES:
    raise TypeError(f'segment-sum kernel takes float32 or bfloat16, got '
                    f'{data.dtype}')
  if data.dim() != 2 or not data.is_contiguous():
    raise ValueError('data must be a contiguous [E, F] CUDA tensor')
  e, f = data.shape
  vec = 16 // data.element_size()
  if f % vec:
    raise ValueError(f'F must be a multiple of {vec} (16-byte loads of '
                     f'{data.dtype}), got {f}')
  cuda_lib.check_aligned({'data': data.data_ptr()})
  if not data.is_cuda:
    raise ValueError('data must be a contiguous [E, F] CUDA tensor')
  if (row_ptr.dtype != torch.int32 or row_ptr.dim() != 1
      or row_ptr.device != data.device or not row_ptr.is_contiguous()):
    raise ValueError('row_ptr must be a contiguous int32 vector on the '
                     'data device')
  if perm is not None and (perm.dtype != torch.int32 or perm.shape != (e,)
                           or perm.device != data.device
                           or not perm.is_contiguous()):
    raise ValueError('perm must be a contiguous int32 [E] on the data device')
  n = row_ptr.shape[0] - 1
  out = torch.empty(n, f, dtype=torch.float32, device=data.device)
  lib = cuda_lib.library()
  stream = torch.cuda.current_stream(data.device).cuda_stream
  code = lib.gt_segment_sum(
      _DTYPE_CODES[data.dtype], data.data_ptr(), row_ptr.data_ptr(),
      None if perm is None else perm.data_ptr(), out.data_ptr(), n, f,
      split_degree, cuda_lib.sm_count(data.device.index), stream)
  cuda_lib.check(code, 'gt_segment_sum')
  KERNEL.launches += 1
  return out


def planned_segment_sum(data: torch.Tensor, row_ptr: torch.Tensor,
                        perm: Optional[torch.Tensor]) -> torch.Tensor:
  """[E, F] -> [N, F]: kernel B on a CUDA tensor (float32 sums), the plain
  version on a CPU tensor (float32 sums in data's dtype)."""
  if not data.is_cuda:
    return planned_segment_sum_plain(data, row_ptr, perm)
  return planned_segment_sum_cuda(data, row_ptr, perm)


def plan_segment_ids(row_ptr: torch.Tensor, perm: Optional[torch.Tensor],
                     num_edges: int) -> torch.Tensor:
  """The segment id of every edge, in the edges' own order, from its plan."""
  n = row_ptr.shape[0] - 1
  counts = (row_ptr[1:] - row_ptr[:-1]).long()
  ids = torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                counts, output_size=num_edges)
  if perm is None:
    return ids
  return torch.empty_like(ids).index_copy_(0, perm.long(), ids)


class _PlannedSegmentSum(torch.autograd.Function):
  """[E, F] -> [N, F] planned sum; its backward gathers the cotangent at
  each edge's segment id (the reference's _pss_bwd)."""

  @staticmethod
  def forward(ctx, x, row_ptr, perm, use_kernel):
    ctx.save_for_backward(row_ptr, perm)
    ctx.num_edges = x.shape[0]
    ctx.dtype = x.dtype
    fn = planned_segment_sum if use_kernel else planned_segment_sum_plain
    return fn(x, row_ptr, perm)

  @staticmethod
  def backward(ctx, g):
    row_ptr, perm = ctx.saved_tensors
    ids = plan_segment_ids(row_ptr, perm, ctx.num_edges)
    # The kernel's float32 sums of bf16 edges: cast the node rows, not the
    # gathered edge rows (the same values, fewer bytes).
    return g.to(ctx.dtype).index_select(0, ids), None, None, None


def segment_sum_planned(data: torch.Tensor, row_ptr: torch.Tensor,
                        perm: Optional[torch.Tensor],
                        f32_accumulate: bool = False,
                        normalization: Optional[float] = None,
                        use_kernel: bool = True,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
  """Planned segment sum of [E, B, C] data -> [N, B, C] in `out_dtype`
  (default data's).

  use_kernel=False takes the plain version on any device (the reference
  path for comparisons on the card). Both sum in float32, as the
  reference's kernel. f32_accumulate keeps that sum in float32 through the
  normalization; without it the sum is rounded to data's dtype first (the
  reference's kernel writes data's dtype). The kernel reads bf16 data
  itself, so on the card no float32 copy of the edges is made; the plain
  version sums the float32 upcast, the same values. out_dtype=float32
  with f32_accumulate returns the float32 sums unrounded (the streamed
  GNN path adds them into a float32 accumulator).
  """
  e = data.shape[0]
  rest = data.shape[1:]
  dtype = data.dtype
  x = data.reshape(e, -1)
  if f32_accumulate and not (use_kernel and x.is_cuda):
    x = x.float()
  out = _PlannedSegmentSum.apply(x.contiguous(), row_ptr, perm, use_kernel)
  if not f32_accumulate:
    out = out.to(dtype)
  if normalization is not None:
    out = out / normalization
  return out.to(out_dtype or dtype).reshape((row_ptr.shape[0] - 1,) + rest)


class _GatherPlanned(torch.autograd.Function):
  """nodes[indices]; its backward is the planned sum of the cotangent over
  the plan built on `indices` (kernel B on the card, reading a bf16
  cotangent itself), in float32 when the cotangent is bf16 (the reference's
  _gp_bwd)."""

  @staticmethod
  def forward(ctx, nodes, indices, row_ptr, perm):
    ctx.save_for_backward(row_ptr, perm)
    return nodes.index_select(0, indices)

  @staticmethod
  def backward(ctx, g):
    row_ptr, perm = ctx.saved_tensors
    grad = segment_sum_planned(g, row_ptr, perm,
                               f32_accumulate=g.dtype != torch.float32)
    return grad, None, None, None


def gather_planned(nodes: torch.Tensor, indices: torch.Tensor,
                   row_ptr: torch.Tensor,
                   perm: Optional[torch.Tensor]) -> torch.Tensor:
  """nodes[indices] along the leading axis, [N, ...] -> [E, ...], for an edge
  side whose AggPlan (row_ptr, perm) is built over `indices` with
  N segments. Its backward is the planned segment sum, never a scatter."""
  return _GatherPlanned.apply(nodes, indices, row_ptr, perm)
