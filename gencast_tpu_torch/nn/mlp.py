"""MLPs with conditional layer normalization (FiLM), as torch.nn modules.

Counterpart of `gencast_tpu.nn.mlp`. Parameter names mirror the reference's
state paths (e.g. `network.layers.0.weight` for `network/layers/0/kernel`),
so `bridge.py` can carry weights across. Initializers follow the reference:
xavier-uniform kernels and zero biases for MLPs, truncated-normal(1e-8) for
the FiLM projection; every draw comes from an explicit torch.Generator.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gencast_tpu_torch.ops import ln_film as ln_film_op

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
  as the reference's noise encoder does under the bf16 cast)."""

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
    return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class MLP(nn.Module):
  """Plain MLP: [in -> hidden]*num_hidden -> out, activation between."""

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
    self.linear = Linear(conditioning_dim, 2 * feature_size, rng=rng,
                         init=truncated_normal(1e-8))


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


class CondMLP(nn.Module):
  """MLP -> LayerNorm(no scale/bias) -> FiLM, the GNN update function (the
  reference's CondMLP with use_layer_norm and use_norm_conditioning, the
  only setting GenCast uses)."""

  def __init__(self, in_size: int, hidden_size: int, num_hidden_layers: int,
               out_size: int, activation: Callable, *, rng: torch.Generator):
    super().__init__()
    self.network = MLP(in_size, hidden_size, num_hidden_layers, out_size,
                       activation, rng=rng)
    self.film = FiLM(out_size, rng=rng)

  def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return ln_film(self.network(x), self.film, cond)


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
        Linear(i, o, rng=rng, init=variance_scaling(2.0, 'uniform'))
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
