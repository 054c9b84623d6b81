"""Weights from the seed, made on the device in one draw.

GenCast's own initialization leaves the attention output, the feed-forward
output and the FiLM projections at (or near) zero, so a freshly built
model is close to the identity and a check of it would say little. The
benchmark draws every parameter instead: one normal draw of all of them at
once from a generator on the device, in float32 (the masters'
type), each matrix scaled by one over the square root of its fan-in, each
FiLM projection by a quarter of that (so that the noise level moves every
LayerNorm's scale and offset by about a quarter), each bias by 0.1. Both the
program and the plain reference get these tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from perfbench.lib import seeds


def scale(name: str, shape: Sequence[int]) -> float:
  if len(shape) == 1:
    return 0.1
  fan_in = shape[-1]
  if name.endswith('linear.weight') and ('film' in name):
    return 0.25 / math.sqrt(fan_in)
  return 1.0 / math.sqrt(fan_in)


def make(shapes: Sequence[Tuple[str, Sequence[int]]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
  """{name: float32 tensor of its shape} on `device`, from `seed`."""
  total = sum(math.prod(s) for _, s in shapes)
  gen = torch.Generator(device=device).manual_seed(
      seeds.derive(seed, seeds.WEIGHTS))
  flat = torch.randn(total, generator=gen, device=device)
  out, offset = {}, 0
  for name, shape in shapes:
    n = math.prod(shape)
    out[name] = flat[offset:offset + n].view(tuple(shape)).mul_(
        scale(name, shape))
    offset += n
  return out
