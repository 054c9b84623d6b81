"""MLPs with conditional layer normalization (FiLM), as torch.nn modules.

Counterpart of `gencast_tpu.nn.mlp`. Parameter names mirror the reference's
state paths (e.g. `network.layers.0.weight` for `network/layers/0/kernel`,
`layer_norm.weight` for `layer_norm/scale`), so `bridge.py` can carry
weights across. Initializers follow the reference: xavier-uniform kernels
and zero biases for MLPs, truncated-normal(1e-8) for the FiLM projection,
ones and zeros for a LayerNorm's scale and bias; every draw comes from an
explicit torch.Generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gencast_tpu_torch.ops import ln_film as ln_film_op
from gencast_tpu_torch.parallel import tensor

CONDITIONING_DIM = 16  # norm-conditioning width used throughout GenCast.

# An initializer fills a [out, in] weight in place from a generator.
Init = Callable[[torch.Tensor, torch.Generator], None]


def xavier_uniform(w: torch.Tensor, rng: torch.Generator) -> None:
  fan_out, fan_in = w.shape
  limit = math.sqrt(6.0 / (fan_in + fan_out))
  with torch.no_grad():
    w.uniform_(-limit, limit, generator=rng)


def truncated_normal(stddev: float) -> Init:
  """Normal(0, stddev) truncated at +-2 stddev (jax truncated_normal)."""
  def init(w: torch.Tensor, rng: torch.Generator) -> None:
    with torch.no_grad():
      if stddev == 0.0:
        w.zero_()
      else:
        nn.init.trunc_normal_(w, 0.0, stddev, -2 * stddev, 2 * stddev,
                              generator=rng)
  return init


def variance_scaling(scale: float, distribution: str) -> Init:
  """Fan-in variance scaling (jax.nn.initializers.variance_scaling)."""
  def init(w: torch.Tensor, rng: torch.Generator) -> None:
    fan_in = w.shape[1]
    variance = scale / fan_in
    if distribution == 'uniform':
      limit = math.sqrt(3.0 * variance)
      with torch.no_grad():
        w.uniform_(-limit, limit, generator=rng)
    elif distribution == 'truncated_normal':
      # Stddev of a unit normal truncated at +-2.
      truncated_normal(math.sqrt(variance) / .87962566103423978)(w, rng)
    else:
      raise ValueError(f'unknown distribution {distribution!r}')
  return init


class Linear(nn.Module):
  """y = x W^T + b with flax's dtype promotion: inputs, weight and bias are
  promoted to their common dtype (an f32 input meets bf16 weights in f32,
  as the reference's noise encoder does under the bf16 cast).

  Under a model axis (parallel/tensor.py) `shard` is 'column' (this rank's
  output features) or 'row' (its input features: the partial products
  summed over `model_axis`, the bias added once after the sum)."""

  shard: Optional[str] = None
  model_axis: Optional[tensor.ModelAxis] = None

  def __init__(self, in_features: int, out_features: int, *,
               rng: torch.Generator, init: Init = xavier_uniform,
               bias: bool = True):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(out_features, in_features))
    init(self.weight, rng)
    self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(x.dtype, self.weight.dtype)
    bias = None if self.bias is None else self.bias.to(dtype)
    if self.shard == 'row':
      return tensor.row_parallel_linear(x.to(dtype), self.weight.to(dtype),
                                        bias, self.model_axis)
    return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class RowwiseLinear(Linear):
  """The [B, D] conditioning path's Linear (the noise encoder, the FiLM
  projections; never sharded): each row of x's leading axes is its own
  one-row product, a batched product of [1, in] by the weight, with
  Linear's dtype promotion. A GEMM of a few rows picks its kernel by the
  row count, so row b of a B-row call would otherwise not be the bits of
  the same row alone, and a member batch's forecast not its members'
  own."""

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(x.dtype, self.weight.dtype)
    rows = x.to(dtype).reshape(-1, 1, x.shape[-1])
    w = self.weight.to(dtype).t().expand(rows.shape[0], -1, -1)
    out = (torch.bmm(rows, w) if self.bias is None else torch.baddbmm(
        self.bias.to(dtype).expand(rows.shape[0], 1, -1), rows, w))
    return out.reshape(x.shape[:-1] + (-1,))


class MLP(nn.Module):
  """Plain MLP: [in -> hidden]*num_hidden -> out, activation between. Under
  a model axis its last two Linears are a column/row pair
  (parallel/tensor.py): the input of the column one is copied in."""

  model_axis: Optional[tensor.ModelAxis] = None

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, activation: Callable, *, rng: torch.Generator):
    super().__init__()
    self.activation = activation
    widths = [hidden_size] * num_hidden_layers + [out_size]
    sizes = [in_size] + widths[:-1]
    self.layers = nn.ModuleList(
        Linear(i, o, rng=rng) for i, o in zip(sizes, widths))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(self.layers):
      if i + 2 == len(self.layers):
        x = tensor.copy_in(x, self.model_axis)
      x = layer(x)
      if i + 1 < len(self.layers):
        x = self.activation(x)
    return x


class FiLM(nn.Module):
  """Linear norm conditioning, x * (1 + scale(cond)) + offset(cond): holds
  the projection of the conditioning; `ln_film` applies it."""

  def __init__(self, feature_size: int, *, rng: torch.Generator,
               conditioning_dim: int = CONDITIONING_DIM):
    super().__init__()
    self.linear = RowwiseLinear(conditioning_dim, 2 * feature_size,
                                rng=rng, init=truncated_normal(1e-8))


def ln_film(x: torch.Tensor, film: FiLM, cond: torch.Tensor) -> torch.Tensor:
  """LayerNorm without scale/bias, then FiLM from the [B, D] conditioning,
  through ops.ln_film (its backward is kernel E on the card): the
  reference's ln_film_reference op order, statistics in float32, the
  normalized value cast back to x's dtype, the FiLM multiply in that dtype.
  x is nodes-leading [N, B, C] or batch-leading [B, N, C]; nodes-leading is
  tried first, as the reference's apply_ln_film."""
  b = cond.shape[0]
  if x.dim() != 3 or b not in x.shape[:2]:
    raise ValueError(f'cannot align conditioning {tuple(cond.shape)} with '
                     f'{tuple(x.shape)}')
  batch_axis = 1 if x.shape[1] == b else 0
  scale_minus_one, offset = film.linear(cond).chunk(2, dim=-1)
  return ln_film_op.ln_film(x, scale_minus_one + 1.0, offset, batch_axis)


class LayerNorm(nn.Module):
  """flax's nnx.LayerNorm over the last axis, with a learned scale
  (`weight`) and bias: epsilon 1e-6, the one-pass variance
  max(E[x^2] - E[x]^2, 0), all in float32 (x, scale and bias promoted), and
  the result cast to the common dtype of x, scale and bias. (torch's
  layer_norm takes the two-pass variance and eps 1e-5.)"""

  def __init__(self, size: int, epsilon: float = 1e-6):
    super().__init__()
    self.epsilon = epsilon
    self.weight = nn.Parameter(torch.ones(size))
    self.bias = nn.Parameter(torch.zeros(size))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + self.epsilon) * self.weight.float()
    y = (xf - mean) * mul + self.bias.float()
    dtype = torch.promote_types(
        x.dtype, torch.promote_types(self.weight.dtype, self.bias.dtype))
    return y.to(dtype)


class CondMLP(nn.Module):
  """MLP -> LayerNorm -> FiLM, the GNN update function (the reference's
  CondMLP). With use_norm_conditioning (GenCast) the LayerNorm has no scale
  or bias and FiLM from the [B, D] conditioning supplies them, through
  `ln_film` (kernel E in its backward on the card); without it (GraphCast)
  the LayerNorm has a learned scale and bias and there is no conditioning;
  without use_layer_norm the MLP alone."""

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, activation: Callable, *, rng: torch.Generator,
               use_layer_norm: bool = True,
               use_norm_conditioning: bool = True):
    super().__init__()
    if use_norm_conditioning and not use_layer_norm:
      raise ValueError('norm conditioning requires layer norm')
    self.network = MLP(in_size, hidden_size, num_hidden_layers, out_size,
                       activation, rng=rng)
    self.use_norm_conditioning = use_norm_conditioning
    if use_norm_conditioning:
      self.film = FiLM(out_size, rng=rng)
    elif use_layer_norm:
      self.layer_norm = LayerNorm(out_size)

  def forward(self, x: torch.Tensor,
              cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = self.network(x)
    if self.use_norm_conditioning:
      if cond is None:
        raise ValueError('conditioning vector required but not provided')
      return ln_film(x, self.film, cond)
    if hasattr(self, 'layer_norm'):
      x = self.layer_norm(x)
    return x


def fourier_features(values: torch.Tensor, base_period: float,
                     num_frequencies: int) -> torch.Tensor:
  """sin/cos features at integer multiples of 1/base_period."""
  # Built on values' device (a host-to-device copy would stall the stream
  # on every denoiser call), in float64 as the reference's numpy.
  freqs = torch.arange(1, num_frequencies + 1, dtype=torch.float64,
                       device=values.device) / base_period
  ang = (2 * math.pi * freqs).to(values.dtype)
  phases = values[..., None] * ang
  return torch.cat([torch.cos(phases), torch.sin(phases)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
  """jax.nn.gelu's default, the tanh approximation."""
  return F.gelu(x, approximate='tanh')


class FourierFeaturesMLP(nn.Module):
  """log -> Fourier features -> small MLP; encodes the noise level sigma
  into the conditioning vector."""

  def __init__(self, base_period: float = 16.0, num_frequencies: int = 32,
               output_sizes: Sequence[int] = (32, 16),
               apply_log_first: bool = True, *, rng: torch.Generator):
    super().__init__()
    self.base_period = base_period
    self.num_frequencies = num_frequencies
    self.apply_log_first = apply_log_first
    sizes = [2 * num_frequencies] + list(output_sizes[:-1])
    self.linears = nn.ModuleList(
        RowwiseLinear(i, o, rng=rng, init=variance_scaling(2.0, 'uniform'))
        for i, o in zip(sizes, output_sizes))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.apply_log_first:
      x = torch.log(x)
    h = fourier_features(x, self.base_period, self.num_frequencies)
    for i, lin in enumerate(self.linears):
      h = lin(h)
      if i + 1 < len(self.linears):
        h = gelu(h)
    return h
