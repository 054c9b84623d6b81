"""Tensor parallelism over the model axis (--mp): Megatron-style pairs.

Counterpart of the reference's `P(None, 'model')` annotations on every
`Linear` kernel (`gencast_tpu.parallel.meshes.shard_model`). There GSPMD
only places the work, and the math is the unsharded model's; here the same
model is computed by explicit pairs over `torch.distributed`:

- attention: q, k and v column-parallel (rank i of the model axis holds
  heads [i·H/mp, (i+1)·H/mp)), `out` row-parallel, so every attention
  backend sees H/mp heads;
- every MLP with a hidden layer (`nn.mlp.MLP`, the transformer's
  `FeedForward`, and so each GNN edge and node MLP and the decoders): the
  last hidden Linear column-parallel over the hidden width, the output
  Linear row-parallel. Inner layers of a deeper MLP stay whole (every
  preset has one hidden layer, so there the first Linear is the column
  one).

What stays replicated sees full-width activations: LayerNorm+FiLM and its
projections, GraphCast's learned-scale LayerNorm, the noise encoder, and
the GNNs' node and edge embedders (whose inputs are a few raw features).
A pair whose width the model axis does not divide stays whole on every
rank, as the reference's `sanitize` replicates a dim that does not divide.

The two collectives are autograd functions (`copy_in`, and the reduce in
`row_parallel_linear`): a
copy at the input of each column-parallel group (identity forward, the
gradient all-reduced backward) and a reduce at the row-parallel output
(all-reduce forward, identity backward), the bias added once after the
sum. Partials are summed in float32 (gloo's bf16 sum is not assumed), one
`all_reduce` each: gloo on CUDA tensors has only `broadcast` and
`all_reduce`, and ranks on one card share it over gloo. Gloo collectives
cannot be captured into a CUDA graph, so a sharded model runs its sampler
and its training step eagerly (`is_sharded`).

Every rank builds (or bridges) the full model and then keeps its slices
(`shard_model`), so a run at --mp 2 from seed s starts from the weights of
--mp 1 from seed s. `gather_state_dict` and `shard_state_dict` move between
the full tensors that checkpoints hold and a rank's slices.

The grid-node axis (the reference's sequence parallelism): a module that
asks for it gives each rank whole latitude rows of the grid (`node_rows`)
in its `custom_shard` hook, which `shard_model` calls. Its GNNs keep their
MLPs whole (a column/row pair cannot also split rows over the same axis)
and run on the rank's rows and edges; the processor keeps its pairs. Its
collectives are float32 all_reduces too: the mesh-side partial sums
(`reduce_sum`), the copies of whole tensors that the rank's rows read
(`copy_in`), the output gathered to every rank (`gather_rows`, a buffer of
-0.0) and, once at the end of the backward pass, the GNNs' partial
parameter gradients (`sum_gradients`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


class ModelAxis:
  """The model axis a sharded module computes over: its process group, its
  size and this rank's index on it. Shared, never copied, by the
  `Bfloat16Cast` serving copy (a deep copy of the model).

  `traffic` counts the calls and bytes of the axis's all_reduces (the
  float32 sums of the forward and the backward's copies; not the
  checkpoints' gathers), read by the training CLI's summary. Their time is
  read from a profiler trace (`--profile_dir`), not kept here."""

  def __init__(self, group, size: int, index: int):
    self.group = group
    self.size = size
    self.index = index
    self.traffic = {'calls': 0, 'bytes': 0}

  def __deepcopy__(self, memo):
    return self

  def __repr__(self) -> str:
    return f'ModelAxis(size={self.size}, index={self.index})'


def _all_reduce_f32(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
  """The sum over the axis's ranks of `x`, in a new float32 tensor."""
  import torch.distributed as dist
  buf = x.to(torch.float32, copy=True)
  dist.all_reduce(buf, group=axis.group)
  axis.traffic['calls'] += 1
  axis.traffic['bytes'] += buf.numel() * 4
  return buf


class _Copy(torch.autograd.Function):
  """Identity forward; the gradient summed over the axis backward."""

  @staticmethod
  def forward(ctx, x, axis):
    ctx.axis = axis
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    return _all_reduce_f32(grad, ctx.axis).to(grad.dtype), None


class _Reduce(torch.autograd.Function):
  """The float32 sum of the ranks' partials forward; identity backward."""

  @staticmethod
  def forward(ctx, x, axis):
    ctx.dtype = x.dtype
    return _all_reduce_f32(x, axis)

  @staticmethod
  def backward(ctx, grad):
    return grad.to(ctx.dtype), None


def reduce_sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
  """The float32 sum over the axis of every rank's `x` (identity backward:
  what reads the sum is the same on every rank, and so its cotangent)."""
  return _Reduce.apply(x, axis)


def copy_in(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
  """`x` at the input of a column-parallel group (as it is without an
  axis)."""
  return x if axis is None else _Copy.apply(x, axis)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], axis: ModelAxis
                        ) -> torch.Tensor:
  """x W_i^T summed over the axis in float32, then the bias added once, in
  float32, and cast to x's dtype: the row-parallel half of a pair (x holds
  this rank's slice of the input features, W_i the matching columns)."""
  total = _Reduce.apply(torch.nn.functional.linear(x, weight), axis)
  if bias is not None:
    total = total + bias.float()
  return total.to(x.dtype)


def axis_of(mesh) -> Optional[ModelAxis]:
  """The model axis of a `parallel.meshes.Mesh`; None for one of size 1."""
  if mesh is None or mesh.axis_size('model') == 1:
    return None
  return ModelAxis(mesh.group('model'), mesh.axis_size('model'),
                   mesh.coords['model'])


def _slice(linear, dim: int, lo: int, hi: int, also_bias: bool) -> None:
  with torch.no_grad():
    linear.weight = nn.Parameter(
        linear.weight.narrow(dim, lo, hi - lo).clone(),
        requires_grad=linear.weight.requires_grad)
    if also_bias and linear.bias is not None:
      linear.bias = nn.Parameter(linear.bias[lo:hi].clone(),
                                 requires_grad=linear.bias.requires_grad)


def _shard_pair(owner: nn.Module, columns: List[nn.Module], row: nn.Module,
                width: int, unit: int, axis: ModelAxis) -> bool:
  """Shards `columns` (their outputs) and `row` (its inputs) over `axis` by
  whole units of `unit` features (a head, or one hidden feature); False,
  and nothing changed, where the axis does not divide width / unit."""
  units = width // unit
  if units % axis.size:
    return False
  lo = axis.index * (units // axis.size) * unit
  hi = lo + (units // axis.size) * unit
  for linear in columns:
    _slice(linear, 0, lo, hi, also_bias=True)
    linear.shard, linear.model_axis = 'column', axis
  _slice(row, 1, lo, hi, also_bias=False)
  row.shard, row.model_axis = 'row', axis
  owner.model_axis = axis
  return True


def shard_model(model: nn.Module, axis: Optional[ModelAxis]
                ) -> Tuple[List[str], List[str]]:
  """Keeps this rank's slices of every pair of `model` (in place; see the
  module docstring) and marks them to compute over `axis`. A module that
  shards itself in a way of its own (a denoiser whose grid nodes are
  sharded) defines `custom_shard(axis)`: it is called first, and the MLPs
  of the modules it returns are neither sharded nor listed. Returns the
  names of the modules sharded and of those that stayed whole. Call it
  once, on the full model, before an optimizer is made over its
  parameters; then `casting.refresh_all` remakes any bf16 serving copy."""
  from gencast_tpu_torch.nn import gnn
  from gencast_tpu_torch.nn.mlp import MLP
  from gencast_tpu_torch.nn.transformer import FeedForward, _QKVProjections
  sharded, whole = [], []
  if axis is None or axis.size == 1:
    return sharded, whole
  embedders = {id(m) for net in model.modules()
               if isinstance(net, gnn.TypedGraphNet)
               for part in (net.node_embedders, net.edge_embedders)
               for m in part.modules()}
  for module in list(model.modules()):
    if hasattr(module, 'custom_shard'):
      embedders |= {id(m) for kept in module.custom_shard(axis)
                    for m in kept.modules()}
  for name, m in model.named_modules():
    if isinstance(m, _QKVProjections):
      done = _shard_pair(m, [m.q, m.k, m.v], m.out,
                         m.cfg.num_heads * m.cfg.head_dim, m.cfg.head_dim,
                         axis)
    elif isinstance(m, FeedForward):
      done = _shard_pair(m, [m.lin1], m.lin2, m.lin1.weight.shape[0], 1,
                         axis)
    elif isinstance(m, MLP) and id(m) not in embedders:
      if len(m.layers) < 2:
        continue  # no hidden layer: nothing to pair
      done = _shard_pair(m, [m.layers[-2]], m.layers[-1],
                         m.layers[-2].weight.shape[0], 1, axis)
    else:
      continue
    (sharded if done else whole).append(name)
  return sharded, whole


def sharded_dims(model: nn.Module) -> Dict[str, int]:
  """{parameter name: the dim it is sharded on} for the sharded parameters
  of `model` (column-parallel weights and biases on dim 0, row-parallel
  weights on dim 1)."""
  dims = {}
  for name, m in model.named_modules():
    shard = getattr(m, 'shard', None)
    if shard is None:
      continue
    prefix = f'{name}.' if name else ''
    dims[f'{prefix}weight'] = 0 if shard == 'column' else 1
    if shard == 'column' and m.bias is not None:
      dims[f'{prefix}bias'] = 0
  return dims


def model_axis(model: nn.Module) -> Optional[ModelAxis]:
  """The axis `model` is sharded over (its pairs' or its grid nodes');
  None when nothing is sharded."""
  for m in model.modules():
    if getattr(m, 'shard', None) is not None:
      return m.model_axis
    if getattr(m, 'node_axis', None) is not None:
      return m.node_axis
  return None


def is_sharded(model: nn.Module) -> bool:
  """Whether `model` runs collectives (then it runs eagerly: they are not
  captured into CUDA graphs)."""
  return model_axis(model) is not None


def gather(x: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
  """The full tensor of every rank's slice `x` along `dim` (slices in rank
  order), bitwise the slices: one all_reduce of a buffer of -0.0 holding
  this rank's slice (x + -0.0 is x, bit for bit)."""
  import torch.distributed as dist
  shape = list(x.shape)
  size = shape[dim]
  shape[dim] = size * axis.size
  buf = torch.full(shape, -0.0, dtype=x.dtype, device=x.device)
  buf.narrow(dim, axis.index * size, size).copy_(x)
  dist.all_reduce(buf, group=axis.group)
  return buf


def _gather_rows(x: torch.Tensor, lo: int, total: int,
                 axis: ModelAxis) -> torch.Tensor:
  """[total, ...] from every rank's rows [lo, lo + len(x)) of it, bitwise:
  one float32 all_reduce of a buffer of -0.0 holding this rank's rows,
  cast back to x's dtype (exact: float32 holds every bf16 value)."""
  import torch.distributed as dist
  buf = torch.full((total,) + tuple(x.shape[1:]), -0.0, dtype=torch.float32,
                   device=x.device)
  buf[lo:lo + x.shape[0]] = x
  dist.all_reduce(buf, group=axis.group)
  axis.traffic['calls'] += 1
  axis.traffic['bytes'] += buf.numel() * 4
  return buf.to(x.dtype)


class _GatherRows(torch.autograd.Function):
  """The node axis's output gathered to every rank forward; this rank's
  rows of the cotangent backward (then `on_backward()`)."""

  @staticmethod
  def forward(ctx, x, lo, total, axis, on_backward):
    ctx.rows = (lo, lo + x.shape[0])
    ctx.on_backward = on_backward
    return _gather_rows(x, lo, total, axis)

  @staticmethod
  def backward(ctx, grad):
    if ctx.on_backward is not None:
      ctx.on_backward()
    lo, hi = ctx.rows
    return grad[lo:hi], None, None, None, None


class _ScatterRows(torch.autograd.Function):
  """This rank's rows of a tensor whole on every rank forward; the rows'
  cotangents gathered to every rank backward."""

  @staticmethod
  def forward(ctx, x, lo, hi, axis):
    ctx.lo, ctx.total, ctx.axis = lo, x.shape[0], axis
    return x[lo:hi]

  @staticmethod
  def backward(ctx, grad):
    return _gather_rows(grad, ctx.lo, ctx.total, ctx.axis), None, None, None


def node_rows(num_lat: int, num_lon: int, axis: ModelAxis
              ) -> Tuple[int, int]:
  """[lo, hi): the grid nodes (latitude-major) of this rank's share of a
  node axis, whole latitude rows, the rows split as numpy's array_split
  splits them (the first ranks take one more where the axis does not
  divide them)."""
  rows = np.array_split(np.arange(num_lat), axis.size)[axis.index]
  if rows.size == 0:
    raise ValueError(f'{num_lat} latitude rows cannot be shared by '
                     f'{axis.size} ranks')
  return int(rows[0]) * num_lon, (int(rows[-1]) + 1) * num_lon


def scatter_rows(x: torch.Tensor, rows: Tuple[int, int], axis: ModelAxis
                 ) -> torch.Tensor:
  """Rows [lo, hi) of `x`, which is whole on every rank (its gradient, if
  one is needed, gathered over the axis)."""
  return _ScatterRows.apply(x, rows[0], rows[1], axis)


def gather_rows(x: torch.Tensor, lo: int, total: int, axis: ModelAxis,
                on_backward=None) -> torch.Tensor:
  """The [total, ...] tensor whose rows [lo, lo + len(x)) are this rank's
  `x`, on every rank (bitwise); backward, this rank's rows of the
  cotangent, after calling `on_backward()`."""
  return _GatherRows.apply(x, lo, total, axis, on_backward)


def sum_gradients(params: List[torch.Tensor], axis: ModelAxis,
                  before: Optional[List[Optional[torch.Tensor]]] = None
                  ) -> None:
  """Each gradient of `params` replaced by its sum over the axis (a missing
  one counts as zeros), with one float32 all_reduce of one flat buffer in
  the parameters' order. Where `before` holds a parameter's gradient from
  before this backward pass (None: it had none), only what the pass added
  to it is summed."""
  import torch.distributed as dist
  if not params:
    return
  before = before or [None] * len(params)
  grads = [p.grad if p.grad is not None else torch.zeros_like(p)
           for p in params]
  grads = [g if b is None else g - b for g, b in zip(grads, before)]
  flat = torch.cat([g.reshape(-1).float() for g in grads])
  dist.all_reduce(flat, group=axis.group)
  axis.traffic['calls'] += 1
  axis.traffic['bytes'] += flat.numel() * 4
  offset = 0
  for p, g, b in zip(params, grads, before):
    summed = flat[offset:offset + g.numel()].view_as(g).to(g.dtype)
    p.grad = summed if b is None else b + summed
    offset += g.numel()


def local_slice(full: torch.Tensor, dim: int, axis: ModelAxis
                ) -> torch.Tensor:
  """This rank's slice of a full tensor along `dim`."""
  size = full.shape[dim] // axis.size
  return full.narrow(dim, axis.index * size, size)


def gather_state_dict(named: Mapping[str, torch.Tensor],
                      dims: Mapping[str, int], axis: Optional[ModelAxis]
                      ) -> Dict[str, torch.Tensor]:
  """Full tensors of `named` (a rank's tensors by parameter name): the
  sharded ones (`dims`) gathered over the axis, in name order on every
  rank; the others as they are. Every rank of the axis must call it."""
  if axis is None:
    return dict(named)
  return {k: gather(v, dims[k], axis) if k in dims else v
          for k, v in named.items()}


def shard_state_dict(named: Mapping[str, torch.Tensor],
                     dims: Mapping[str, int], axis: Optional[ModelAxis]
                     ) -> Dict[str, torch.Tensor]:
  """This rank's slices of full tensors `named` (the sharded ones, `dims`)."""
  if axis is None:
    return dict(named)
  return {k: local_slice(v, dims[k], axis) if k in dims else v
          for k, v in named.items()}
