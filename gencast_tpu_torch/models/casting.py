"""Mixed precision: bf16 compute with float32 master weights.

Counterpart of `gencast_tpu.models.casting.Bfloat16Cast`: float inputs are
cast to bf16, the inner predictor runs with bf16 parameters, and outputs
come back as float32. LayerNorm statistics, softmax and the planned
grid2mesh aggregation still run in float32 inside (ops/ln_film.py, the
attention kernels, ops/segment.py f32_accumulate).

* Serving (`forward`, `sample`, `predict`) runs a cached bf16 copy of the
  predictor, made once (`refresh()`), so no call pays for the cast.
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


def _layout(model: nn.Module) -> tuple:
  """What a serving copy of `model` is made from, beyond the values of its
  parameters: each parameter's identity, shape, dtype and device, each
  buffer's identity (the copy shares them), and the axes its modules
  compute over (parallel/tensor.py). While it holds, a refresh can copy
  values in place."""
  return (tuple((id(p), p.shape, p.dtype, p.device)
                for p in model.parameters()),
            tuple(id(b) for b in model.buffers()),
            tuple((id(getattr(m, 'model_axis', None)),
                   id(getattr(m, 'node_axis', None)))
                  for m in model.modules()))


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
    """Brings the bf16 copy up to the predictor's current parameters: the
    master values copied into the copy's own parameters when the predictor
    is laid out as when the copy was made (new weights from training or a
    checkpoint), so the CUDA graphs captured on the copy stay valid;
    otherwise (moved, sharded, new buffers) a new copy."""
    layout = _layout(self.predictor)
    twin = self.__dict__.get('_bf16')
    if twin is not None and self.__dict__.get('_bf16_layout') == layout:
      with torch.no_grad():
        for master, p in zip(self.predictor.parameters(), twin.parameters()):
          p.copy_(master)
      return
    # Kept out of the module tree (in __dict__, not as a submodule) so that
    # .to() and state_dict() see only the master weights.
    self.__dict__['_bf16'] = cast_params(self.predictor)
    self.__dict__['_bf16_layout'] = layout

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
    """The bf16 copy's sample, float32 out; keyword arguments (a member
    batch's `generators` or per-member `noise`) go to GenCast.sample."""
    i, f = self._in(inputs, forcings)
    kwargs.setdefault('dtype', torch.bfloat16)
    return self._bf16.sample(i, f, generator, **kwargs).float()

  def predict(self, inputs, forcings, generator=None, **kwargs):
    """The deterministic forward (GraphCast) of the bf16 copy, float32 out."""
    i, f = self._in(inputs, forcings)
    return self._bf16.predict(i, f, generator, **kwargs).float()


def refresh_all(model: nn.Module) -> None:
  """Brings the serving copy of every Bfloat16Cast in `model` up to its
  master weights (`Bfloat16Cast.refresh`): after training, or after loading
  a checkpoint (the copy lives outside `state_dict`, so a load does not
  reach it)."""
  for m in model.modules():
    if isinstance(m, Bfloat16Cast):
      m.refresh()
