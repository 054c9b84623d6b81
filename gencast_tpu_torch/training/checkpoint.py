"""Checkpoint save/restore with training-state resume.

Counterpart of `gencast_tpu.training.checkpoint` (an orbax manager there):
a directory of one file per saved step, `step_<n>.pt`, holding

* the model's parameters, by their names in the wrapped stack (the
  reference's `_trainable_state`: parameters only; plans, masks, graph and
  per-channel buffers are rebuilt by the graph compiler, which keeps the
  files small and independent of those tables);
* with an optimizer, its AdamW state (`torch.optim.AdamW.state_dict()`:
  the moments and their per-parameter step) and `Optimizer.step_count`, the
  step of the warmup/cosine schedule, so a resumed run continues the
  schedule instead of restarting the warmup.

Files are written to a temporary name and published with os.replace, the
newest `max_to_keep` are kept, and they load with
`torch.load(..., weights_only=True)`. A restore refreshes every
Bfloat16Cast's serving copy, which lives outside `state_dict`.

Under a model axis (`parallel.tensor`) a file holds the full tensors, the
parameters and AdamW's moments gathered over the axis, so it restores at
any --mp (a rank keeps its slices), as orbax's do in the reference.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional

import torch
from torch import nn

from gencast_tpu_torch.models import casting
from gencast_tpu_torch.parallel import tensor
from gencast_tpu_torch.training import steps as steps_lib

_FILE = re.compile(r'^step_(\d+)\.pt$')


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
  directory: str
  max_to_keep: int = 3


def create_manager(directory: str, max_to_keep: int = 3
                   ) -> CheckpointManager:
  directory = os.path.abspath(directory)
  os.makedirs(directory, exist_ok=True)
  return CheckpointManager(directory, max_to_keep)


def _path(manager: CheckpointManager, step: int) -> str:
  return os.path.join(manager.directory, f'step_{step}.pt')


def all_steps(manager: CheckpointManager) -> List[int]:
  """The saved steps, ascending."""
  return sorted(int(m.group(1)) for m in map(_FILE.match,
                                             os.listdir(manager.directory))
                if m)


def latest_step(manager: CheckpointManager) -> Optional[int]:
  saved = all_steps(manager)
  return saved[-1] if saved else None


def save(manager: CheckpointManager, step: int, model: nn.Module,
         optimizer: Optional[steps_lib.Optimizer] = None,
         write: bool = True) -> None:
  """Saves step `step`: the file is written where `write` (the rank that
  writes). Under a model axis every rank of the axis must call it, since
  the full tensors are gathered over it."""
  axis = tensor.model_axis(model)
  if axis is None and not write:
    return
  params = tensor.gather_state_dict(
      {name: p.detach() for name, p in model.named_parameters()},
      tensor.sharded_dims(model), axis)
  state = {'step': step, 'params': {k: v.cpu() for k, v in params.items()}}
  if optimizer is not None:
    state['opt_state'] = optimizer.state_dict()
  if not write:
    return
  path = _path(manager, step)
  tmp = f'{path}.tmp{os.getpid()}'
  torch.save(state, tmp)
  os.replace(tmp, path)
  for old in all_steps(manager)[:-manager.max_to_keep]:
    os.remove(_path(manager, old))


def restore(manager: CheckpointManager, model: nn.Module,
            optimizer: Optional[steps_lib.Optimizer] = None,
            step: Optional[int] = None) -> int:
  """Restores the parameters (and the optimizer's state) in place; returns
  the step. The checkpoint must hold exactly the model's parameters (under
  a model axis, the full tensors of this rank's slices)."""
  if step is None:
    step = latest_step(manager)
  if step is None:
    raise FileNotFoundError(f'no checkpoint in {manager.directory}')
  state = torch.load(_path(manager, step), map_location='cpu',
                     weights_only=True)
  params = dict(model.named_parameters())
  saved = tensor.shard_state_dict(state['params'],
                                  tensor.sharded_dims(model),
                                  tensor.model_axis(model))
  if params.keys() != saved.keys():
    raise KeyError(f'checkpoint step {step} holds other parameters: missing '
                   f'{sorted(params.keys() - saved.keys())}, unexpected '
                   f'{sorted(saved.keys() - params.keys())}')
  with torch.no_grad():
    for name, p in params.items():
      if p.shape != saved[name].shape:
        raise ValueError(f'{name}: checkpoint {tuple(saved[name].shape)}, '
                         f'model {tuple(p.shape)}')
      p.copy_(saved[name])
  if optimizer is not None:
    optimizer.load_state_dict(state['opt_state'])
  casting.refresh_all(model)
  return int(state['step'])
