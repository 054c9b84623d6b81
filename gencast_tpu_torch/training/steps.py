"""The training step and its optimizer.

Counterpart of `gencast_tpu.training.steps` (`OptimizerConfig`,
`create_optimizer`, `train_step`): optax's chain of global-norm clipping at
1.0 and AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.1 on every
parameter: the reference passes no mask) under a linear-warmup / cosine
schedule, with the reference's warmup clamp. As in optax, the first update
uses the schedule's value at step 0, which is 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
  learning_rate: float = 3e-4
  warmup_steps: int = 1000
  total_steps: int = 30000
  weight_decay: float = 0.1
  clip_norm: float = 1.0
  b1: float = 0.9
  b2: float = 0.999
  final_lr_fraction: float = 0.0


def warmup_cosine_schedule(config: OptimizerConfig) -> Callable[[int], float]:
  """optax.warmup_cosine_decay_schedule(0, lr, warmup, total_steps,
  lr * final_lr_fraction) with the reference's clamp of the warmup to
  max(1, total_steps // 10): a linear rise over the warmup steps, then a
  cosine decay over the remaining total_steps - warmup."""
  warmup = min(config.warmup_steps, max(1, config.total_steps // 10))
  decay = config.total_steps - warmup
  if decay <= 0:
    raise ValueError(f'total_steps ({config.total_steps}) must exceed the '
                     f'warmup ({warmup})')
  peak = config.learning_rate
  alpha = 0.0 if peak == 0.0 else config.final_lr_fraction

  def schedule(step: int) -> float:
    if step < warmup:
      return peak * min(step, warmup) / warmup
    count = min(step - warmup, decay)
    cosine = 0.5 * (1 + math.cos(math.pi * count / decay))
    return peak * ((1 - alpha) * cosine + alpha)

  return schedule


def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
  """optax.clip_by_global_norm, in place: every gradient times
  max_norm / norm when the global norm is not below max_norm (no epsilon,
  unlike torch's clip_grad_norm_). Returns the norm, on the device."""
  grads = list(grads)
  norm = torch.linalg.vector_norm(
      torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
  factor = torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)
  for g in grads:
    g.mul_(factor.to(g.dtype))
  return norm


class Optimizer:
  """AdamW over `params` under the warmup-cosine schedule, after global-norm
  clipping of their gradients: the reference's optax chain. `update()` takes
  one step from the parameters' `.grad`."""

  def __init__(self, params: Iterable[nn.Parameter], config: OptimizerConfig):
    self.params = [p for p in params if p.requires_grad]
    self.config = config
    self.schedule = warmup_cosine_schedule(config)
    self.step_count = 0
    # foreach: one launch per group of tensors rather than per tensor.
    self.adamw = torch.optim.AdamW(
        self.params, lr=self.schedule(0), betas=(config.b1, config.b2),
        eps=1e-8, weight_decay=config.weight_decay, foreach=True)

  def zero_grad(self) -> None:
    for p in self.params:
      p.grad = None

  def update(self) -> torch.Tensor:
    """Clips, steps at the schedule's current rate; returns the gradient
    norm before clipping (on the device)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in self.params]
    for p, g in zip(self.params, grads):
      p.grad = g
    norm = clip_by_global_norm_(grads, self.config.clip_norm)
    for group in self.adamw.param_groups:
      group['lr'] = self.schedule(self.step_count)
    self.adamw.step()
    self.step_count += 1
    return norm


def create_optimizer(model: nn.Module, config: OptimizerConfig) -> Optimizer:
  """The reference's AdamW + warmup/cosine recipe over model's parameters
  (the float32 masters under a Bfloat16Cast)."""
  return Optimizer(model.parameters(), config)


def train_step(model: nn.Module, optimizer: Optimizer,
               inputs: torch.Tensor, targets: torch.Tensor,
               forcings: torch.Tensor,
               generator: Optional[torch.Generator] = None, **kwargs
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """One optimization step on the mean loss over the batch; returns (mean
  loss, per-variable diagnostics), both detached and on the device.
  `generator` draws sigma and the noise; keyword arguments (sigma=,
  noise=) inject them instead."""
  optimizer.zero_grad()
  loss, diags = model.loss(inputs, targets, forcings, generator, **kwargs)
  loss = loss.mean()
  loss.backward()
  optimizer.update()
  return loss.detach(), {k: v.detach() for k, v in diags.items()}
