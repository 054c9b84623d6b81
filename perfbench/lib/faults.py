"""Faults planted in the timed path, for the tests and readings that show
the check catches them: each replaces part of a cell (before its set-up)
and leaves the rest of the run as it is.

Forecast cells: `unchanged` (each member's forecast is the inputs' last
frame: a step that returns its state), `half_batch` (the second half of
the members is a copy of the first: half the batch left out), `altered`
(one channel of every forecast moved by a few standard deviations of its
12-hour change, where the rollout produces it). Training cells:
`unchanged` (every step puts the parameters back), `altered` (the loss
read back is doubled). A one-chip cell has no exchange between chips to
leave out.
"""

from __future__ import annotations

import torch

FORECAST = ('unchanged', 'half_batch', 'altered')
TRAIN = ('unchanged', 'altered')


def plant(cell, fault: str) -> None:
  if cell.kind == 'forecast':
    _forecast(cell, fault)
  else:
    _train(cell, fault)


def _forecast(cell, fault: str) -> None:
  from gencast_tpu_torch.parallel import ensemble

  def rollout(stack, inputs, forcings, **kw):
    out = ensemble.ensemble_rollout(stack, inputs, forcings, **kw)
    if fault == 'unchanged':
      base = stack._residual_base(inputs).cpu()
      out.copy_(base.expand_as(out[:, 0]).unsqueeze(1).expand_as(out))
    elif fault == 'half_batch':
      half = out.shape[0] // 2
      out[half:2 * half] = out[:half]
    elif fault == 'altered':
      scale = stack.tgt_scale.cpu()
      out[..., 0] += 3.0 * scale[0]
    else:
      raise ValueError(fault)
    return out

  cell.rollout = rollout


def _train(cell, fault: str) -> None:
  def wrap(fused, c):
    if fault == 'unchanged':
      def step(pool, idx, steps, seed):
        losses = fused(pool, idx, steps, seed)
        with torch.no_grad():
          for n, p in c.prog.model.named_parameters():
            p.copy_(c.weights[n])
        return losses
    elif fault == 'altered':
      def step(pool, idx, steps, seed):
        return fused(pool, idx, steps, seed) * 2.0
    else:
      raise ValueError(fault)
    return step

  cell.wrap_step = wrap
