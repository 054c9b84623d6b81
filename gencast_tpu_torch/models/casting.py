"""Mixed-precision serving: bf16 compute with float32 master weights.

Counterpart of `gencast_tpu.models.casting.Bfloat16Cast`: float inputs are
cast to bf16, the inner predictor runs with a bf16 copy of its parameters,
and outputs come back as float32. Softmax and the planned grid2mesh
aggregation still run in float32 inside (nn/precision.py, the attention
kernel, ops/segment.py f32_accumulate).
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def cast_params(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
  """A copy of `model` whose floating-point parameters are cast to `dtype`.

  Buffers (graph features, plans, the noise basis) are shared with `model`,
  not copied, and keep their dtypes.
  """
  memo = {id(b): b for b in model.buffers()}
  twin = copy.deepcopy(model, memo)
  with torch.no_grad():
    for p in twin.parameters():
      if p.is_floating_point():
        p.data = p.data.to(dtype)
  return twin


class Bfloat16Cast(nn.Module):
  """Predictor wrapper running the inner model in bf16.

  The bf16 copy of the parameters is made when the wrapper is built, from
  the predictor as it is then (weights and device). After loading new
  weights into the predictor, call `refresh()`.
  """

  def __init__(self, predictor: nn.Module):
    super().__init__()
    self.predictor = predictor
    self.refresh()

  def refresh(self) -> None:
    """Remakes the bf16 copy from the predictor's current parameters."""
    # Kept out of the module tree (in __dict__, not as a submodule) so that
    # .to() and state_dict() see only the master weights.
    self.__dict__['_bf16'] = cast_params(self.predictor)

  @staticmethod
  def _in(*arrays):
    return tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                 for a in arrays)

  def forward(self, inputs, noisy_targets, noise_levels, forcings):
    i, t, f = self._in(inputs, noisy_targets, forcings)
    return self._bf16(i, t, noise_levels, f).float()

  def sample(self, inputs, forcings, generator=None, **kwargs):
    i, f = self._in(inputs, forcings)
    kwargs.setdefault('dtype', torch.bfloat16)
    return self._bf16.sample(i, f, generator, **kwargs).float()
