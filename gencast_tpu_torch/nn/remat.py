"""Activation recomputation that sees the parameters its forward saw.

Counterpart of `jax.checkpoint` around a module's method. Under
`models.casting.Bfloat16Cast.loss` the model runs with its parameters
replaced, for the duration of one call, by their bf16 casts
(`torch.func.functional_call`); a plain `torch.utils.checkpoint` would
recompute in the backward pass, after that call has returned, with the
float32 master parameters instead. Here the module's parameters, as the
forward finds them, are inputs of the checkpoint, and the recomputation
binds them again.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint
from torch import nn

from gencast_tpu_torch import utils


class _Bound(nn.Module):
  """Runs fn(*args) while functional_call binds `module`'s parameters."""

  def __init__(self, module: nn.Module):
    super().__init__()
    self.module = module

  def forward(self, fn: Callable, *args):
    return fn(*args)


def call_with_parameters(module: nn.Module, params, fn: Callable, *args,
                         **kwargs):
  """fn(*args, **kwargs) with `module`'s parameters replaced by `params`
  ({name: tensor}) for the duration of the call."""
  return torch.func.functional_call(
      _Bound(module), {f'module.{k}': v for k, v in params.items()},
      (lambda *a: fn(*a, **kwargs),) + args)


def checkpoint(module: nn.Module, fn: Callable, *args) -> torch.Tensor:
  """Non-reentrant `torch.utils.checkpoint` of fn(*args), where fn reads the
  parameters of `module`: the backward recomputes fn with the parameter
  tensors of this call. Nothing in fn may draw random numbers (the RNG
  state is not saved)."""
  names, tensors = zip(*module.named_parameters())
  count = len(args)

  def run(*flat):
    # Marked in the forward pass and again where the backward recomputes
    # (`utils.SPANS`); a recomputation that stops early has no end mark.
    with utils.span('remat', flat[0].device):
      return call_with_parameters(module, dict(zip(names, flat[count:])),
                                  fn, *flat[:count])

  return torch.utils.checkpoint.checkpoint(
      run, *args, *tensors, use_reentrant=False, preserve_rng_state=False)
