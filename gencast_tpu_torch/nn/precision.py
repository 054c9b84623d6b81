"""bf16 numerics guards.

Counterpart of `gencast_tpu.nn.precision`: softmax (and similar
reductions) run in float32 even when activations are bf16, and
`reduce_precision` strips excess precision identically in the forward and
the backward pass, so bf16 training gradients stay consistent (the guard of
DeepMind's gencast/sparse_transformer_utils.py). The einsum attention
backends ('triblock', 'dense') use it around their softmax.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

# The (exponent, mantissa) bits of the narrow formats with_f32 guards.
_FINFO_BITS = {torch.bfloat16: (8, 7), torch.float16: (5, 10)}


def _round(x: torch.Tensor, exponent_bits: int, mantissa_bits: int
           ) -> torch.Tensor:
  """jax.lax.reduce_precision of a float32 tensor, bit for bit (XLA's
  ReducePrecision on the float32 bits, as unsigned integers): the mantissa
  rounded to nearest even; with fewer than 8 exponent bits, values whose
  exponent is past the narrow format's largest become infinities and those
  at or under its smallest (its denormals) become signed zeros; NaN is
  kept."""
  if x.dtype != torch.float32:
    raise ValueError(f'reduce_precision takes float32, got {x.dtype}')
  if (exponent_bits, mantissa_bits) == (8, 7):
    # bfloat16: the same rounding, through the dtype (a NaN's payload may
    # change), without the integer temporaries.
    return x.to(torch.bfloat16).float()
  bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
  if mantissa_bits < 23:
    last = 1 << (23 - mantissa_bits)
    bias = ((bits & last) >> (23 - mantissa_bits)) + (last >> 1) - 1
    bits = (bits + bias) & (0xFFFFFFFF & ~(last - 1))
  if exponent_bits < 8:
    sign = bits & 0x80000000
    exponent = bits & 0x7F800000
    reduced_bias = (1 << (exponent_bits - 1)) - 1
    overflows = exponent > ((127 + reduced_bias) << 23)
    underflows = exponent <= ((127 - reduced_bias) << 23)
    bits = torch.where(overflows, sign | 0x7F800000,
                       torch.where(underflows, sign, bits))
  bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
  out = bits.to(torch.int32).view(torch.float32)
  return torch.where(torch.isnan(x), x, out)


class _ReducePrecision(torch.autograd.Function):
  """Rounds to the narrow format and back, in the forward and on the
  cotangent (the reference's custom_vjp)."""

  @staticmethod
  def forward(ctx, x, exponent_bits, mantissa_bits):
    ctx.bits = (exponent_bits, mantissa_bits)
    return _round(x, exponent_bits, mantissa_bits)

  @staticmethod
  def backward(ctx, dout):
    return _round(dout, *ctx.bits), None, None


def _tree_map(fn, tree):
  if isinstance(tree, (tuple, list)):
    return type(tree)(_tree_map(fn, t) for t in tree)
  return fn(tree)


def _first_leaf(tree) -> torch.Tensor:
  while isinstance(tree, (tuple, list)):
    tree = tree[0]
  return tree


def reduce_precision(x: Any, exponent_bits: int, mantissa_bits: int) -> Any:
  """Every float32 tensor of `x` (a tensor or nested tuples and lists of
  them) rounded to a float of `exponent_bits` and `mantissa_bits`, still in
  float32, as jax.lax.reduce_precision; its gradient rounds the cotangent
  the same way."""
  return _tree_map(
      lambda t: _ReducePrecision.apply(t, exponent_bits, mantissa_bits), x)


def with_f32(fn: Callable[[Any], Any], inputs: Any,
             guard_excess_precision: bool = True) -> Any:
  """Runs `fn` on float32 upcasts of `inputs` (a tensor or nested tuples of
  them), downcasting its result to the inputs' dtype; with
  guard_excess_precision the upcasts are first rounded to the inputs'
  format (`reduce_precision`). Inputs already in float32 go straight to
  `fn`."""
  orig = _first_leaf(inputs).dtype
  if orig == torch.float32:
    return fn(inputs)
  x = _tree_map(lambda t: t.float(), inputs)
  if guard_excess_precision:
    x = reduce_precision(x, *_FINFO_BITS[orig])
  return _tree_map(lambda t: t.to(orig), fn(x))
