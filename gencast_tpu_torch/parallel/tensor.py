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
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

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
  module docstring) and marks them to compute over `axis`. Returns the
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
  """The axis `model` is sharded over; None when nothing is sharded."""
  for m in model.modules():
    if getattr(m, 'shard', None) is not None:
      return m.model_axis
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
