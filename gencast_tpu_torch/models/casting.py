"""Mixed precision: bf16 compute with float32 master weights.

Counterpart of `gencast_tpu.models.casting.Bfloat16Cast`: float inputs are
cast to bf16, the inner predictor runs with bf16 parameters, and outputs
come back as float32. LayerNorm statistics, softmax and the planned
grid2mesh aggregation still run in float32 inside (ops/ln_film.py, the
attention kernels, ops/segment.py f32_accumulate).

* Serving (`forward`, `sample`) runs a cached bf16 copy of the predictor,
  made once (`refresh()`), so no call pays for the cast.
* Training (`loss`, `loss_and_predictions`) runs the predictor itself under
  `torch.func.functional_call` with its parameters cast per call, so the
  cast is part of the autograd graph and gradients reach the float32
  masters, as the reference's cast inside the traced graph.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from gencast_tpu_torch.nn import remat


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

  The bf16 copy that serves `forward`/`sample` is made when the wrapper is
  built, from the predictor as it is then (weights and device). After
  loading or training new weights into the predictor, call `refresh()`.
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

  def _cast_params(self):
    return {name: p.to(torch.bfloat16) if p.is_floating_point() else p
            for name, p in self.predictor.named_parameters()}

  def loss_and_predictions(self, inputs, targets, forcings, generator=None,
                           **kwargs):
    """The predictor's loss, diagnostics and predictions (float32), computed
    in bf16 with parameters cast from the float32 masters in this call."""
    i, t, f = self._in(inputs, targets, forcings)
    (loss, diags), preds = remat.call_with_parameters(
        self.predictor, self._cast_params(),
        self.predictor.loss_and_predictions, i, t, f, generator, **kwargs)
    return ((loss.float(), {k: v.float() for k, v in diags.items()}),
            preds.float())

  def loss(self, inputs, targets, forcings, generator=None, **kwargs):
    (loss, diags), _ = self.loss_and_predictions(inputs, targets, forcings,
                                                 generator, **kwargs)
    return loss, diags

  def forward(self, inputs, noisy_targets, noise_levels, forcings):
    i, t, f = self._in(inputs, noisy_targets, forcings)
    return self._bf16(i, t, noise_levels, f).float()

  def sample(self, inputs, forcings, generator=None, **kwargs):
    i, f = self._in(inputs, forcings)
    kwargs.setdefault('dtype', torch.bfloat16)
    return self._bf16.sample(i, f, generator, **kwargs).float()
