"""Autoregressive forecast rollouts and the multi-step training loss.

Counterpart of `gencast_tpu.rollout` (`advance_inputs`, `rollout`,
`sample_rollout`, `predict_rollout`, `chunked_rollout` in its 'sample' and
'predict' modes, and `autoregressive_loss`). The reference's `lax.scan`
over forecast steps is a Python loop here (on the card each denoiser call
of a sampled step, and each forward of a deterministic one, replays a CUDA
graph); the input window advances on the device by one channel gather per
step. The reference splits one key into per-step keys; here the caller
gives either one `torch.Generator`, drawn from step after step, or each
step's precomputed noise fields (as `GenCast.sample` takes them), and the
training loss keys each step's generator by (its keys, step). Given one
generator or noise per member, `sample_rollout` runs the members as one
batch (the reference's vmap over member keys); `chunked_rollout` runs one
member.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.models import diffusion_utils
from gencast_tpu_torch.models import gencast as gencast_lib
from gencast_tpu_torch.models.wrappers import find_layout_provider
from gencast_tpu_torch.nn import remat as remat_lib

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
            teacher_targets: Optional[torch.Tensor] = None,  # [K, B, ...]
            return_final_inputs: bool = False):
  """K autoregressive steps; returns predictions [K, B, lat, lon, C_tgt],
  and with return_final_inputs also the window after the last step (the
  inputs of a step K + 1).

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
  if return_final_inputs:
    return torch.stack(predictions), carry
  return torch.stack(predictions)


@torch.no_grad()
def sample_rollout(model: nn.Module,
                   inputs: torch.Tensor,
                   forcings: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Sequence] = None,
                   teacher_targets: Optional[torch.Tensor] = None,
                   jit: bool = True, return_final_inputs: bool = False,
                   generators: Optional[Sequence[torch.Generator]] = None):
  """Diffusion-sampled autoregressive rollout of a (wrapped) GenCast model.

  `model` exposes .sample(inputs, forcings, generators=..., noise=...) in
  raw (unnormalized) space, e.g. InputsAndResiduals(NaNCleaner(GenCast)).
  Randomness comes from `generator`, drawn from step after step, or from
  `noise`: for each of the K steps the N + 1 unit noise fields that
  `GenCast.sample` takes. With teacher_targets [K, B, lat, lon, C_tgt] the
  window advances with them (teacher forcing, see `rollout`). Returns
  [K, B, lat, lon, C_tgt].

  Members as one batch (the reference's vmapped ensemble): given
  `generators` (one per member) or `noise` per member (M lists of the K
  steps' fields), the window, forcings and teacher targets are repeated
  per member along the batch, each denoiser call samples all M·B rows at
  once, and each member draws from its own generator or noise as its own
  rollout would. Returns [M, K, B, lat, lon, C_tgt]. One generator, or one
  member's noise, runs the same path as a batch of one member.

  `jit` is the reference's flag: on the card, True replays each denoiser
  call from the model's CUDA graph (`GenCast.sample`), False runs every
  call eagerly; on the CPU both run eagerly. return_final_inputs also
  returns the window after the last step (see `rollout`; [M, B, ...] for
  members).
  """
  generators, noise, one = gencast_lib.member_draws(generator, generators,
                                                    noise, 2)
  for steps in noise or []:
    if len(steps) != forcings.shape[0]:
      raise ValueError(f'noise for {len(steps)} steps, forcings for '
                       f'{forcings.shape[0]}')
  members = len(generators or noise)

  def predict(x, frc, step):
    if generators is not None:
      return model.sample(x, frc, generators=generators, graphed=jit)
    return model.sample(x, frc, noise=[n[step] for n in noise], graphed=jit)

  batch = inputs.shape[0]
  teacher = (None if teacher_targets is None
             else torch.cat([teacher_targets] * members, dim=1))
  out = rollout(predict, torch.cat([inputs] * members),
                torch.cat([forcings] * members, dim=1), _maps(model), teacher,
                return_final_inputs=True)
  preds = out[0].unflatten(1, (members, batch)).movedim(1, 0)
  window = out[1].unflatten(0, (members, batch))
  if one:
    preds, window = preds[0], window[0]
  return (preds, window) if return_final_inputs else preds


def _maps(model: nn.Module) -> layout_lib.RolloutMaps:
  d = find_layout_provider(model)
  return layout_lib.rollout_maps(d.input_layout, d.target_layout,
                                 d.forcing_layout)


def advance_index(model: nn.Module, num_inputs: int, num_targets: int,
                  device) -> torch.Tensor:
  """The window advance's channel gather for `model`'s layouts, on
  `device` (made outside a CUDA graph: it is a host-to-device copy)."""
  return torch.as_tensor(
      _advance_index(_maps(model), num_inputs, num_targets), device=device)


def autoregressive_loss(model: nn.Module,
                        inputs: torch.Tensor,     # [B, lat, lon, C_in]
                        targets: torch.Tensor,    # [K, B, lat, lon, C_t]
                        forcings: torch.Tensor,   # [K, B, lat, lon, C_f]
                        keys: Optional[Sequence[int]] = None,
                        remat: bool = True,
                        index: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """The multi-step training loss: K steps of `model.loss_and_predictions`
  with the window advanced on the model's own predictions, gradients
  through the whole rollout. Returns (the per-step losses' mean [B], the
  per-variable diagnostics' means).

  Step k draws from the generator of (*keys, k) (`diffusion_utils.
  keyed_generator`, on the inputs' device), made inside the step so that
  its recomputation draws the same; a deterministic model (GraphCast)
  draws nothing, and without `keys` no generator is passed. With `remat`
  each step is recomputed in the backward pass (the reference's
  jax.checkpoint of its scan body): only the step's window is kept.
  `index` is `advance_index`'s, made here when not given (a graphed step
  gives it: it cannot be made under capture).
  """
  if index is None:
    index = advance_index(model, inputs.shape[-1], targets.shape[-1],
                          inputs.device)
  names = None

  def body(k, carry, frc, tgt):
    nonlocal names
    generator = (None if keys is None else diffusion_utils.keyed_generator(
        *keys, k, device=inputs.device))
    (loss, diags), preds = model.loss_and_predictions(carry, tgt, frc,
                                                      generator)
    names = sorted(diags)
    return ((_advance(carry, preds, frc, index), loss)
            + tuple(diags[n] for n in names))

  carry = inputs
  step_losses, step_diags = [], []
  for k in range(targets.shape[0]):
    fn = lambda *a, k=k: body(k, *a)  # noqa: E731
    if remat and torch.is_grad_enabled():
      out = remat_lib.checkpoint(model, fn, carry, forcings[k], targets[k])
    else:
      out = fn(carry, forcings[k], targets[k])
    carry, loss = out[0], out[1]
    step_losses.append(loss)
    step_diags.append(dict(zip(names, out[2:])))
  loss = torch.stack(step_losses).mean(dim=0)
  diags = {n: torch.stack([d[n] for d in step_diags]).mean(dim=0)
           for n in names}
  return loss, diags


@torch.no_grad()
def predict_rollout(model: nn.Module,
                    inputs: torch.Tensor,
                    forcings: torch.Tensor,
                    teacher_targets: Optional[torch.Tensor] = None,
                    jit: bool = True, return_final_inputs: bool = False):
  """Deterministic autoregressive rollout of a (wrapped) GraphCast:
  `model.predict(inputs, forcings)` step after step, [K, B, lat, lon,
  C_tgt]. With teacher_targets the window advances with them (teacher
  forcing, see `rollout`); return_final_inputs also returns the window
  after the last step.

  `jit` is the reference's flag: on the card True replays each step's
  forward from the model's CUDA graph (`GraphCast.predict`), False runs it
  eagerly; on the CPU both run eagerly.
  """
  def predict(x, frc, step):
    return model.predict(x, frc, graphed=jit)

  return rollout(predict, inputs, forcings, _maps(model), teacher_targets,
                 return_final_inputs=return_final_inputs)


@torch.no_grad()
def chunked_rollout(model: nn.Module,
                    inputs: torch.Tensor,    # [B, lat, lon, C_in]
                    forcings: torch.Tensor,  # [K, B, lat, lon, C_frc]
                    generator: Optional[torch.Generator] = None,
                    *,
                    chunk_size: int,
                    noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                    mode: str = 'sample',
                    teacher_targets: Optional[torch.Tensor] = None,
                    overlap_offload: bool = True,
                    jit: bool = True) -> torch.Tensor:
  """A long rollout in chunks of `chunk_size` steps, each chunk's
  predictions moved to the host (the reference's chunked_rollout): the
  device holds the input window and one or two chunks of predictions,
  never all K steps (a 30-step 0.25-degree forecast is 10 GB in float32).
  mode 'sample' samples each step (`sample_rollout`), mode 'predict' takes
  the deterministic forward (`predict_rollout`; `generator` and `noise`
  are not used). Returns host [K, B, lat, lon, C_tgt], bitwise the
  unchunked rollout's for any chunk_size: the draws are the generator's
  stream (or `noise`, per step), consumed step after step.

  overlap_offload copies chunk c - 1's predictions to pinned host memory
  on a side stream while chunk c computes; False copies each chunk before
  the next starts. The last chunk runs only the steps left: the reference
  pads it so every chunk has one compiled shape, and the port's CUDA
  graphs are per denoiser call or forward, which a shorter chunk does not
  change.
  """
  if mode not in ('sample', 'predict'):
    raise ValueError(f"chunked_rollout: mode must be 'sample' or "
                     f"'predict', got {mode!r}")
  if chunk_size < 1:
    raise ValueError(f'chunk_size must be positive, got {chunk_size}')
  num_steps = forcings.shape[0]
  side = (torch.cuda.Stream(inputs.device)
          if overlap_offload and inputs.is_cuda else None)
  out = None
  pending = None  # (device predictions, copy-done event) of the last chunk
  window = inputs
  for lo in range(0, num_steps, chunk_size):
    sl = slice(lo, min(lo + chunk_size, num_steps))
    teacher = None if teacher_targets is None else teacher_targets[sl]
    if mode == 'predict':
      preds, window = predict_rollout(
          model, window, forcings[sl], teacher_targets=teacher, jit=jit,
          return_final_inputs=True)
    else:
      preds, window = sample_rollout(
          model, window, forcings[sl], generator,
          noise=None if noise is None else noise[sl],
          teacher_targets=teacher, jit=jit, return_final_inputs=True)
    if out is None:
      out = torch.empty((num_steps,) + preds.shape[1:], dtype=preds.dtype,
                        pin_memory=side is not None)
    if side is None:
      out[sl].copy_(preds)
      continue
    # The copy waits for this chunk on the side stream; the next chunk's
    # work is queued on the compute stream meanwhile.
    side.wait_stream(torch.cuda.current_stream(inputs.device))
    with torch.cuda.stream(side):
      out[sl].copy_(preds, non_blocking=True)
      done = torch.cuda.Event()
      done.record(side)
    # The caching allocator must not hand preds' memory to the compute
    # stream before the side stream has read it.
    preds.record_stream(side)
    if pending is not None:
      pending.synchronize()
    pending = done
  if pending is not None:
    pending.synchronize()
  return out
