"""The training step and its optimizer.

Counterpart of `gencast_tpu.training.steps` (`OptimizerConfig`,
`create_optimizer`, `train_step`): optax's chain of global-norm clipping at
1.0 and AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.1 on every
parameter: the reference passes no mask) under a linear-warmup / cosine
schedule, with the reference's warmup clamp. As in optax, the first update
uses the schedule's value at step 0, which is 0. `ar_train_step` trains
GraphCast's autoregressive loss over a K-frame window.
`scanned_train_steps` is the counterpart of the reference's fused
multi-step training: on the card K steps per host call replay one CUDA
graph of the step (the one-frame loss, or with `ar=True` the
autoregressive one).

Data parallelism (`Optimizer(data_group=...)`): after the backward and
before the clip, the gradients and the step's loss are averaged over the
data ranks with one `all_reduce` of one flat float32 buffer, in the
parameters' order (no DDP: the step runs through Bfloat16Cast's
functional_call and torch.utils.checkpoint, and one ordered buffer keeps
the sum deterministic). With equal rows per rank that is the gradient of
the global-batch mean loss, which the reference's sharded jit computes.

Under a model axis (`parallel.tensor`) a rank's optimizer holds its slices
of the sharded parameters and their moments: the data-axis average runs
within the rank's data group (the ranks of its model coordinate), and the
clip's global norm is the unsharded model's, the squared norms of the
sharded gradients summed over the model axis and each replicated one
counted once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from gencast_tpu_torch import utils
from gencast_tpu_torch.models import diffusion_utils
from gencast_tpu_torch.ops import cuda_lib


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
                         max_norm: float,
                         sharded: Optional[Sequence[bool]] = None,
                         model_axis=None) -> torch.Tensor:
  """optax.clip_by_global_norm, in place: every gradient times
  max_norm / norm when the global norm is not below max_norm (no epsilon,
  unlike torch's clip_grad_norm_). Returns the norm, on the device.

  Under a model axis (`parallel.tensor.ModelAxis`), `sharded[i]` says
  whether grads[i] is this rank's slice of a sharded parameter: the norm
  is the unsharded model's, the sharded gradients' squared norms summed
  over the axis (one all_reduce) and every replicated gradient, the same
  on each rank, counted once."""
  grads = list(grads)
  norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
  if model_axis is None:
    norm = torch.linalg.vector_norm(norms)
  else:
    import torch.distributed as dist
    mask = torch.as_tensor(list(sharded), device=norms.device)
    squares = norms * norms
    total = squares[mask].sum()
    dist.all_reduce(total, group=model_axis.group)
    norm = torch.sqrt(total + squares[~mask].sum())
  factor = torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)
  for g in grads:
    g.mul_(factor.to(g.dtype))
  return norm


class Optimizer:
  """AdamW over `params` under the warmup-cosine schedule, after global-norm
  clipping of their gradients: the reference's optax chain. `update()` takes
  one step from the parameters' `.grad`.

  On the card the AdamW update is capturable: its step counts live on the
  card and its rate is a 0-d float32 tensor that `set_rate` fills before
  each step, so a CUDA graph of the step (`scanned_train_steps`) reads each
  replay's rate, where a float would be frozen into the graph. The per-step
  loop on the card runs the same update, so the two give the same bits. On
  the CPU the rate is a float, as before.
  """

  def __init__(self, params: Iterable[nn.Parameter], config: OptimizerConfig,
               data_group=None, model_axis=None,
               shard_dims: Optional[Sequence[Optional[int]]] = None):
    self.params = [p for p in params if p.requires_grad]
    self.config = config
    # The process group of the data axis (parallel.meshes), whose ranks
    # average their gradients; None: this process's batch is the batch.
    self.data_group = data_group
    # The model axis (parallel.tensor.ModelAxis) and, per parameter, the
    # dim it is sharded on (None: replicated, every rank the whole).
    self.model_axis = model_axis
    self.shard_dims = (list(shard_dims) if shard_dims is not None
                       else [None] * len(self.params))
    self.schedule = warmup_cosine_schedule(config)
    self.step_count = 0  # on the host: the schedule's and checkpoints' step
    capturable = bool(self.params) and self.params[0].is_cuda
    self.lr = (torch.zeros((), dtype=torch.float32,
                           device=self.params[0].device)
               if capturable else None)
    # foreach: one launch per group of tensors rather than per tensor.
    self.adamw = torch.optim.AdamW(
        self.params, lr=self.schedule(0) if self.lr is None else self.lr,
        betas=(config.b1, config.b2), eps=1e-8,
        weight_decay=config.weight_decay, foreach=True,
        capturable=capturable)
    # Eager steps of the capturable update are meant (see above): no
    # warning that they could be captured.
    self.adamw._warned_capturable_if_run_uncaptured = True

  def zero_grad(self) -> None:
    for p in self.params:
      p.grad = None

  def average_over_ranks(self, loss: torch.Tensor) -> torch.Tensor:
    """Under a data group: every parameter's gradient and `loss` (0-d)
    replaced by their means over the group's ranks, with one all_reduce of
    one flat float32 buffer (gloo has no other collective on CUDA
    tensors). Returns the mean loss; without a group, `loss`."""
    if self.data_group is None:
      return loss
    import torch.distributed as dist
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in self.params]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.detach().reshape(1).float()])
    dist.all_reduce(flat, group=self.data_group)
    flat.div_(dist.get_world_size(self.data_group))
    offset = 0
    for p, g in zip(self.params, grads):
      p.grad = flat[offset:offset + g.numel()].view_as(g).to(g.dtype)
      offset += g.numel()
    return flat[-1]

  def set_rate(self) -> None:
    """Sets the rate of step `step_count` (on the card, into the rate
    tensor: a kernel launch, no copy from the host)."""
    rate = self.schedule(self.step_count)
    if self.lr is None:
      for group in self.adamw.param_groups:
        group['lr'] = rate
    else:
      self.lr.fill_(rate)

  def apply(self) -> torch.Tensor:
    """Clips and steps at the rate `set_rate` set: the part of `update()`
    that runs on the device, which a CUDA graph captures. Returns the
    gradient norm before clipping (on the device)."""
    with utils.span('optimizer', self.params[0].device):
      grads = [p.grad if p.grad is not None else torch.zeros_like(p)
               for p in self.params]
      for p, g in zip(self.params, grads):
        p.grad = g
      norm = clip_by_global_norm_(
          grads, self.config.clip_norm,
          [dim is not None for dim in self.shard_dims], self.model_axis)
      self.adamw.step()
    return norm

  def update(self) -> torch.Tensor:
    """Clips, steps at the schedule's current rate; returns the gradient
    norm before clipping (on the device)."""
    self.set_rate()
    norm = self.apply()
    self.step_count += 1
    return norm

  def _moments(self, adamw: dict, fn) -> dict:
    """`adamw` (an AdamW state dict) with fn(moment, dim) in place of each
    moment of a sharded parameter, in parameter order."""
    state = {i: {k: fn(v, self.shard_dims[i])
                 if k != 'step' and self.shard_dims[i] is not None else v
                 for k, v in sorted(entry.items())}
             for i, entry in sorted(adamw['state'].items())}
    return dict(adamw, state=state)

  def state_dict(self) -> dict:
    """The AdamW state and the step count, as checkpoints keep them: under
    a model axis with the moments of the sharded parameters gathered (every
    rank of the axis must call it)."""
    adamw = self.adamw.state_dict()
    if self.model_axis is not None:
      from gencast_tpu_torch.parallel import tensor
      adamw = self._moments(adamw, lambda v, dim: tensor.gather(
          v, dim, self.model_axis))
    return {'adamw': adamw, 'step_count': self.step_count}

  def load_state_dict(self, state: dict) -> None:
    """Restores the AdamW state (full moments; under a model axis each
    rank keeps its slices) and the step count. The moments are new
    tensors afterwards: a CUDA graph captured before reads the old ones
    (`scanned_train_steps` captures anew)."""
    adamw = state['adamw']
    if self.model_axis is not None:
      from gencast_tpu_torch.parallel import tensor
      adamw = self._moments(adamw, lambda v, dim: tensor.local_slice(
          v, dim, self.model_axis).clone())
    self.adamw.load_state_dict(adamw)
    if self.lr is not None:
      # The saved rate (a tensor or a float) replaced the rate tensor.
      for group in self.adamw.param_groups:
        group['lr'] = self.lr
    self.step_count = state['step_count']


def create_optimizer(model: nn.Module, config: OptimizerConfig,
                     data_group=None) -> Optimizer:
  """The reference's AdamW + warmup/cosine recipe over model's parameters
  (the float32 masters under a Bfloat16Cast); with `data_group`, the
  gradients are averaged over its ranks before the clip. Under a model
  axis (a model sharded by `parallel.tensor.shard_model`), the clip takes
  the unsharded model's norm."""
  from gencast_tpu_torch.parallel import tensor
  dims = tensor.sharded_dims(model)
  named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
  return Optimizer([p for _, p in named], config, data_group=data_group,
                   model_axis=tensor.model_axis(model),
                   shard_dims=[dims.get(n) for n, _ in named])


def train_step(model: nn.Module, optimizer: Optimizer,
               inputs: torch.Tensor, targets: torch.Tensor,
               forcings: torch.Tensor,
               generator: Optional[torch.Generator] = None, **kwargs
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """One optimization step on the mean loss over the batch (with the
  optimizer's data group, over the ranks' batches); returns (mean loss,
  per-variable diagnostics of this process's batch), both detached and on
  the device. `generator` draws sigma and the noise; keyword arguments
  (sigma=, noise=) inject them instead."""
  optimizer.zero_grad()
  loss, diags = model.loss(inputs, targets, forcings, generator, **kwargs)
  loss = loss.mean()
  with utils.span('backward', loss.device):
    loss.backward()
  loss = optimizer.average_over_ranks(loss.detach())
  optimizer.update()
  return loss, {k: v.detach() for k, v in diags.items()}


def ar_train_step(model: nn.Module, optimizer: Optimizer,
                  inputs: torch.Tensor, targets: torch.Tensor,
                  forcings: torch.Tensor, keys=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """One optimization step on the mean multi-step loss
  (`rollout.autoregressive_loss`) over targets and forcings of K frames
  ([K, B, lat, lon, C]); returns (mean loss, per-variable diagnostics),
  detached, on the device. Step k of the rollout draws from the generator
  of (*keys, k) where the model draws at all (GraphCast does not)."""
  from gencast_tpu_torch import rollout
  optimizer.zero_grad()
  loss, diags = rollout.autoregressive_loss(model, inputs, targets,
                                            forcings, keys=keys)
  loss = loss.mean()
  with utils.span('backward', loss.device):
    loss.backward()
  optimizer.update()
  return loss.detach(), {k: v.detach() for k, v in diags.items()}


def draws_owner(model: nn.Module) -> Optional[nn.Module]:
  """The GenCast inside a wrapper stack, whose `training_draws` the loss
  calls; None for a model that draws nothing (GraphCast)."""
  m = model
  while not hasattr(m, 'training_draws'):
    if not hasattr(m, 'predictor'):
      return None
    m = m.predictor
  return m


class FusedTrainSteps:
  """`scanned_train_steps`' callable: fused_fn(pool, idx, steps, seed) ->
  losses [K].

  Per step it stages, on the host and outside any graph, the step's pool
  row, its rate (`Optimizer.set_rate`) and its draws (the noise level and
  noise of the generator of (seed, step), `GenCast.training_draws`; a
  GraphCast draws nothing) into static buffers, then runs `_step`: the
  row's gather by a device index, the mean loss (with `ar`, the
  autoregressive loss over the row's K-frame window), its backward (with
  the remat recomputation), the clip and the AdamW update. On the card
  `_step` is one CUDA graph: the first step runs it eagerly on the graph's
  side stream (the warm-up), the graph is captured after it, and every
  later step replays it. The graph holds the addresses of the pool, the
  parameters and the optimizer's tensors, so it is captured anew when a
  call finds any of them changed (a checkpoint restore gives the moments
  new tensors). On the CPU `_step` runs eagerly.
  """

  def __init__(self, model: nn.Module, optimizer: Optimizer,
               ar: bool = False):
    self.model = model
    self.optimizer = optimizer
    self.ar = ar
    self.draws = draws_owner(model)
    if ar and self.draws is not None:
      # A step's draws would be made inside its graph, frozen at capture.
      raise ValueError('fused autoregressive training takes a deterministic '
                       'model (GraphCast)')
    self.graph = None        # cuda_lib.Graph, on the card
    self.captured = None     # the addresses the graph holds
    self.loss = None         # the graph's output
    self.row = self.sigma = self.noise = None
    self.index = None        # the AR window advance's gather (rollout)

  def _addresses(self, pool) -> tuple:
    opt = self.optimizer
    tensors = ([pool[k] for k in sorted(pool)] + opt.params
               + [t for state in opt.adamw.state.values()
                  for t in state.values() if torch.is_tensor(t)])
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)

  def _stage(self, pool, row: int, step: int, seed: int) -> None:
    device = pool['inputs'].device
    if self.row is None:
      self.row = torch.zeros(1, dtype=torch.long, device=device)
    self.row.fill_(row)
    if self.ar and self.index is None:
      from gencast_tpu_torch import rollout
      self.index = rollout.advance_index(
          self.model, pool['inputs'].shape[-1], pool['targets'].shape[-1],
          device)
    if self.draws is not None:
      generator = diffusion_utils.keyed_generator(seed, step, device=device)
      sigma, noise = self.draws.training_draws(generator,
                                               pool['targets'].shape[1])
      if self.sigma is None:
        self.sigma, self.noise = (torch.empty_like(sigma),
                                  torch.empty_like(noise))
      self.sigma.copy_(sigma)
      self.noise.copy_(noise)
    self.optimizer.set_rate()

  def _step(self, pool) -> torch.Tensor:
    batch = [pool[k].index_select(0, self.row)[0]
             for k in ('inputs', 'targets', 'forcings')]
    self.optimizer.zero_grad()
    if self.ar:
      from gencast_tpu_torch import rollout
      loss, _ = rollout.autoregressive_loss(self.model, *batch,
                                            index=self.index)
    elif self.draws is None:
      loss, _ = self.model.loss(*batch)
    else:
      loss, _ = self.model.loss(*batch, sigma=self.sigma, noise=self.noise)
    loss = loss.mean()
    with utils.span('backward', loss.device):
      loss.backward()
    self.optimizer.apply()
    return loss.detach()

  def __call__(self, pool: Dict[str, torch.Tensor], idx: Sequence[int],
               steps: Sequence[int], seed: int) -> torch.Tensor:
    idx, steps = [int(i) for i in idx], [int(s) for s in steps]
    if len(idx) != len(steps):
      raise ValueError(f'{len(idx)} pool rows for {len(steps)} steps')
    device = pool['inputs'].device
    losses = torch.empty(len(steps), dtype=torch.float32, device=device)
    card = device.type == 'cuda'
    for k, (row, step) in enumerate(zip(idx, steps)):
      with utils.span('train.stage', unit=f'step={step}'):
        if k == 0 and self._addresses(pool) != self.captured:
          # A graph reads what it captured: start anew, buffers and all
          # (on the CPU, where nothing is captured, at every call).
          self.graph = self.captured = self.loss = None
          self.row = self.sigma = self.noise = None
        self._stage(pool, row, step, seed)
      if not card:
        losses[k] = self._step(pool)
      elif self.graph is None:
        graph = cuda_lib.Graph(device)
        losses[k] = graph.warm_up(lambda: self._step(pool))
        # After the warm-up: its step made the optimizer's moments.
        self.captured = self._addresses(pool)
        self.loss = graph.capture(lambda: self._step(pool))
        self.graph = graph
      else:
        with utils.span('train.replay', unit=f'step={step}'):
          self.graph.replay()
        losses[k] = self.loss
      self.optimizer.step_count += 1
    return losses


def scanned_train_steps(model: nn.Module, optimizer: Optimizer,
                        ar: bool = False) -> FusedTrainSteps:
  """Fused multi-step training: K optimizer steps per host call over a
  device-resident sample pool. Counterpart of the reference's
  `scanned_train_steps` (one jitted `lax.scan` of K steps there): on the
  card each step replays one CUDA graph of the whole step (see
  `FusedTrainSteps`), in place on `model` and `optimizer`.

  Returns fused_fn(pool, idx, steps, seed) -> losses [K] (float32, on the
  pool's device), where pool is a dict of [M, B, lat, lon, C] tensors
  ('inputs'/'targets'/'forcings') on the model's device, idx the K pool
  rows of the steps and steps their K global step numbers: step s draws
  from the generator of (seed, s), as the per-step loop's
  `train.step_generator`, so both give the same bits.

  With ar=True each step trains the autoregressive loss
  (`rollout.autoregressive_loss`, gradients through the whole rollout) of
  a deterministic model (GraphCast); the pool's 'targets' and 'forcings'
  then hold [M, K_ar, B, lat, lon, C] windows, as the reference's.
  """
  return FusedTrainSteps(model, optimizer, ar=ar)
