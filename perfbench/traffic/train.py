"""Training traffic: optimizer steps at batch 1, one host call each.

As the training CLI's fused mode runs them (`training.steps.
scanned_train_steps` over a device pool): a pool of `pool_size` synthetic
windows (two input frames and a target, drawn from the run's seed) on the
device; each step takes the pool row of a permutation drawn from the seed,
draws its noise level and noise from the generator of (the run's step
seed, the step), and replays one CUDA graph of the whole step: the EDM
loss, its backward with remat, the global-norm clip and AdamW at the
warm-up and cosine schedule's rate. Each host call runs one step; the
window keeps about `AHEAD_S` seconds of steps dispatched ahead of the one
whose loss it reads back, as a loop that logs its losses late does, so a
host that stands still for less than that does not stall the card.

Set-up builds the model, the optimizer and the pool, and drives steps 0-2
(step 0 runs eagerly and captures the graph; steps 1 and 2 replay it),
keeping what the check needs: the first gradient as the optimizer got it
(from AdamW's first moment after step 0), the losses and the parameters
after step 2. The window continues from step 3 on the same objects; the
check runs the plain reference through steps 0-2 from the same weights,
rows and draws.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.lib import flops, phases, program, seeds, synthetic, weights
from perfbench.lib.compare import (Comparison, leaf_norms, loss_gap,
                                   norm_gaps, worst)
from perfbench.reference import graph as graph_lib
from perfbench.reference import model as ref

CHECKED_STEPS = 3
# A leaf whose first reference gradient is under this share of the median
# leaf's moves by round-off alone under AdamW: its change is not compared.
STILL_LEAF = 1e-3
# Seconds of steps the window dispatches ahead of the loss it reads back.
AHEAD_S = 5.0


class Cell:
  kind = 'train'

  def __init__(self, config: dict, params: dict, seed: int, device):
    self.cfg = config
    self.params = params
    self.seed = seed
    self.device = torch.device(device)
    self.pool_size = int(params['pool_size'])
    self.step_seed = seeds.derive(seed, seeds.STEPS)
    self.step = 0
    self.attempted = 0
    self.ahead = 1           # steps dispatched ahead; set from step 2
    self.pending = collections.deque()
    # The program's step function; the check's tests plant faults in it.
    self.wrap_step = None

  def _sync(self) -> None:
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)

  def _windows(self, rows) -> List[tuple]:
    w = synthetic.Weather(self.cfg, self.stats, self.device)
    return [w.window(seeds.derive(self.seed, seeds.POOL, int(i)))
            for i in rows]

  def _rows(self, count: int) -> List[int]:
    """The pool rows of steps 0 .. count - 1: permutations of the pool
    drawn from the seed, one after another."""
    r = seeds.rng(self.seed, seeds.POOL)
    out: List[int] = []
    while len(out) < count:
      out.extend(int(i) for i in r.permutation(self.pool_size))
    return out[:count]

  # --- set-up ---

  def setup(self) -> None:
    from gencast_tpu_torch.training import steps as steps_lib
    self.phases = phases.Phases()
    self.prog = program.build(self.cfg, self.device)
    self.phases.mark('model')
    self.weights = weights.make(program.shapes(self.prog), self.seed,
                                self.device)
    self.stats = synthetic.stats(self.cfg, self.seed)
    program.load(self.prog, self.weights, self.stats, self.cfg)
    self.phases.mark('weights')
    o = self.cfg['optimizer']
    self.optimizer = steps_lib.create_optimizer(
        self.prog.stack, steps_lib.OptimizerConfig(
            learning_rate=o['learning_rate'], warmup_steps=o['warmup_steps'],
            total_steps=o['total_steps'], weight_decay=o['weight_decay'],
            clip_norm=o['clip_norm'], b1=o['b1'], b2=o['b2']))
    self.fused = steps_lib.scanned_train_steps(self.prog.stack,
                                               self.optimizer)
    if self.wrap_step is not None:
      self.fused = self.wrap_step(self.fused, self)
    windows = self._windows(range(self.pool_size))
    self.pool = {k: torch.stack([w[i] for w in windows])[:, None]
                 for i, k in enumerate(('inputs', 'targets', 'forcings'))}
    del windows
    self.order = self._rows(1 << 16)
    self.phases.mark('optimizer and pool')
    self.losses = []
    for _ in range(CHECKED_STEPS):
      t0 = time.perf_counter()
      self.losses.append(float(self._dispatch()))
      if self.step == 1:
        self.first_grads = self._first_gradients()
        self.phases.mark('step 0 (captures)')
    # Step 2, a replay with its loss read back, sets how many steps make
    # AHEAD_S seconds.
    self.ahead = max(1, math.ceil(AHEAD_S / (time.perf_counter() - t0)))
    names = [program.model_name(n)
             for n, _ in self.prog.stack.named_parameters()]
    self.after = {n: p.detach().clone() for n, p in zip(
        names, self.prog.stack.parameters())}
    self.phases.mark('steps 1-2')

  def _first_gradients(self) -> Dict[str, float]:
    """Norms of the gradients AdamW took at its first step: its first
    moment is then (1 - b1) times the gradient."""
    b1 = self.cfg['optimizer']['b1']
    out = {}
    for (n, p) in self.prog.stack.named_parameters():
      state = self.optimizer.adamw.state.get(p, {})
      m = state.get('exp_avg')
      out[program.model_name(n)] = (
          float(torch.linalg.vector_norm(m.double())) / (1 - b1)
          if m is not None else 0.0)
    return out

  def _dispatch(self) -> torch.Tensor:
    """One step, dispatched: its loss, on the device."""
    with torch.profiler.record_function('perfbench.step'):
      loss = self.fused(self.pool, [self.order[self.step]], [self.step],
                        self.step_seed)[0]
    self.step += 1
    self.attempted += 1
    return loss

  def unit(self) -> None:
    """One step of the window: dispatched, and the loss of the step
    `ahead` steps back read."""
    self.pending.append(self._dispatch())
    while len(self.pending) > self.ahead:
      float(self.pending.popleft())

  def drain(self) -> None:
    """Reads back every loss still pending: all that was sent is done."""
    while self.pending:
      float(self.pending.popleft())
    self._sync()

  # --- the window ---

  def window(self, seconds: float) -> Dict[str, float]:
    """Steps until `seconds` have passed; then nothing more is sent, all
    that was sent is waited for, and the clock is read after that wait."""
    self._sync()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
      self.unit()
      n += 1
    self.drain()
    end = time.perf_counter()
    return {'train_step_ms': 1e3 * (end - t0) / n}

  # --- what the readers need ---

  def flops_per_unit(self, graph: graph_lib.Graph) -> float:
    return flops.train_step(self.cfg, graph, 1)

  def attention_launch(self, graph: graph_lib.Graph) -> dict:
    c = self.cfg
    shape = dict(batch=1, nodes=graph.num_mesh, heads=c['num_heads'],
                 head_dim=c['d_model'] // c['num_heads'],
                 pairs=graph.attention_pairs)
    return {'A': shape, 'F-dq': shape, 'F-dk/dv': shape}

  def free(self) -> None:
    self.prog = self.optimizer = self.fused = self.pool = None

  # --- the check ---

  def check(self, graph: graph_lib.Graph,
            precision: Optional[ref.Precision] = None,
            every: bool = False) -> List[Comparison]:
    """The numbers the cell's file gives a limit (`every`: all of them,
    the others against an infinite limit, for the calibration)."""
    precision = precision or ref.Precision('f32')
    rows = self.order[:CHECKED_STEPS]
    examples = self._windows(rows)
    keys = [(self.step_seed, s) for s in range(CHECKED_STEPS)]
    got = ref.train_steps(self.cfg, graph, self.weights, self.stats,
                          examples, keys, precision, self.device)
    want_grads = leaf_norms(got['first_grads'])
    median = float(np.median(list(want_grads.values())))
    moving = {n for n, v in want_grads.items() if v >= STILL_LEAF * median}
    change_ref = leaf_norms({n: got['params'][n] - self.weights[n]
                             for n in moving})
    change_prog = leaf_norms({n: self.after[n] - self.weights[n]
                              for n in moving})
    readings = {
        'loss_rel_gap': loss_gap(self.losses, got['losses']),
        'grad_norm_gap': worst(norm_gaps(self.first_grads, want_grads)),
        'change_norm_gap': worst(norm_gaps(change_prog, change_ref))}
    limits = self.params['limits']
    return [Comparison(n, v, limits.get(n, math.inf))
            for n, v in readings.items() if every or n in limits]
