"""Autoregressive forecast rollouts.

Counterpart of `gencast_tpu.rollout` (`advance_inputs`, `rollout`,
`sample_rollout`). The reference's `lax.scan` over forecast steps is a
Python loop here (on the card each denoiser call replays a CUDA graph); the input window advances on the device by one channel
gather per step. The reference splits one key into per-step keys; here the
caller gives either one `torch.Generator`, drawn from step after step, or
each step's precomputed noise fields (as `GenCast.sample` takes them).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.models.wrappers import find_layout_provider

# predict_fn(inputs [B, lat, lon, C_in], step forcings [B, lat, lon, C_frc],
# step index) -> predictions [B, lat, lon, C_tgt].
PredictFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def _advance_index(maps: layout_lib.RolloutMaps, num_inputs: int,
                   num_targets: int) -> np.ndarray:
  """For each input channel, its source channel in
  concat([inputs, predictions, forcings], -1)."""
  offsets = np.asarray([0, num_inputs, num_inputs + num_targets])
  keep = maps.source == 3
  index = offsets[np.where(keep, 0, maps.source)] + maps.index
  return np.where(keep, np.arange(num_inputs), index).astype(np.int64)


def _advance(inputs, predictions, step_forcings, index: torch.Tensor):
  return torch.cat([inputs, predictions, step_forcings],
                   dim=-1).index_select(-1, index)


def advance_inputs(inputs: torch.Tensor, predictions: torch.Tensor,
                   step_forcings: torch.Tensor,
                   maps: layout_lib.RolloutMaps) -> torch.Tensor:
  """Drops the oldest frame and appends the new one, on the inputs' device.

  inputs [B, lat, lon, C_in]; predictions [B, lat, lon, C_tgt];
  step_forcings [B, lat, lon, C_frc] (values at the newly predicted time).
  """
  index = _advance_index(maps, inputs.shape[-1], predictions.shape[-1])
  return _advance(inputs, predictions, step_forcings,
                  torch.as_tensor(index, device=inputs.device))


def rollout(predict_fn: PredictFn,
            inputs: torch.Tensor,      # [B, lat, lon, C_in]
            forcings: torch.Tensor,    # [K, B, lat, lon, C_frc]
            maps: layout_lib.RolloutMaps,
            teacher_targets: Optional[torch.Tensor] = None  # [K, B, ...]
            ) -> torch.Tensor:
  """K autoregressive steps; returns predictions [K, B, lat, lon, C_tgt].

  With teacher_targets, the window advances with the ground truth instead
  of the model's own predictions (teacher forcing, as in the reference's
  evaluation loop), while the model's predictions are still returned.
  """
  index = None  # made once, at the first step's predictions
  carry = inputs
  predictions = []
  for step in range(forcings.shape[0]):
    preds = predict_fn(carry, forcings[step], step)
    if index is None:
      index = torch.as_tensor(
          _advance_index(maps, inputs.shape[-1], preds.shape[-1]),
          device=inputs.device)
    truth = preds if teacher_targets is None else teacher_targets[step]
    carry = _advance(carry, truth, forcings[step], index)
    predictions.append(preds)
  return torch.stack(predictions)


@torch.no_grad()
def sample_rollout(model: nn.Module,
                   inputs: torch.Tensor,
                   forcings: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                   teacher_targets: Optional[torch.Tensor] = None,
                   jit: bool = True) -> torch.Tensor:
  """Diffusion-sampled autoregressive rollout of a (wrapped) GenCast model.

  `model` exposes .sample(inputs, forcings, generator, noise=...) in raw
  (unnormalized) space, e.g. InputsAndResiduals(NaNCleaner(GenCast)).
  Randomness comes from `generator`, drawn from step after step, or from
  `noise`: for each of the K steps the N + 1 unit noise fields that
  `GenCast.sample` takes. With teacher_targets [K, B, lat, lon, C_tgt] the
  window advances with them (teacher forcing, see `rollout`). Returns
  [K, B, lat, lon, C_tgt].

  `jit` is the reference's flag: on the card, True replays each denoiser
  call from the model's CUDA graph (`GenCast.sample`), False runs every
  call eagerly; on the CPU both run eagerly.
  """
  if (generator is None) == (noise is None):
    raise ValueError('sample_rollout needs a generator or per-step noise')
  if noise is not None and len(noise) != forcings.shape[0]:
    raise ValueError(f'noise for {len(noise)} steps, forcings for '
                     f'{forcings.shape[0]}')
  d = find_layout_provider(model)
  maps = layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)

  def predict(x, frc, step):
    if noise is None:
      return model.sample(x, frc, generator, graphed=jit)
    return model.sample(x, frc, noise=noise[step], graphed=jit)

  return rollout(predict, inputs, forcings, maps, teacher_targets)
