"""Forecast traffic: ensemble forecast steps requested back to back.

One client in a closed loop, as an evaluation over initial times runs: a
request is one 12-hour forecast step of `members` members from a fresh
initial state (inputs and the step's forcings, synthetic weather drawn
from the run's seed and the request's index), sampled through the
program's `parallel.ensemble.ensemble_rollout` with the members in groups
of `member_chunk` as one batch, each denoiser call replayed from its CUDA
graph, member m drawing from the generator of (the request's seed, m), and
the forecast copied to the host as the rollout does. The next request goes
out when the last is on the host.

Set-up builds the model, loads the weights and runs one request of the
same shapes (it captures the denoiser call's graph). The window counts the
requests that end; the check draws one request that ended, and in it one
member from each half of the batch, and runs the plain reference over the
same inputs and the same draws.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from perfbench.lib import flops, phases, program, seeds, synthetic, weights
from perfbench.lib.compare import Comparison, relative_l2
from perfbench.reference import graph as graph_lib
from perfbench.reference import model as ref


class Cell:
  kind = 'forecast'

  def __init__(self, config: dict, params: dict, seed: int, device):
    self.cfg = config
    self.params = params
    self.seed = seed
    self.device = torch.device(device)
    self.members = int(params['members'])
    self.chunk = int(params.get('member_chunk', self.members))
    self.outputs: List[torch.Tensor] = []   # per request, on the host
    self.attempted = 0
    # Replaced by the check's tests to plant a fault in the timed path.
    self.rollout = None

  # --- set-up ---

  def setup(self) -> None:
    from gencast_tpu_torch.parallel import ensemble
    self.rollout = self.rollout or ensemble.ensemble_rollout
    self.phases = phases.Phases()
    self.prog = program.build(self.cfg, self.device)
    self.phases.mark('model')
    self.weights = weights.make(program.shapes(self.prog), self.seed,
                                self.device)
    self.stats = synthetic.stats(self.cfg, self.seed)
    program.load(self.prog, self.weights, self.stats, self.cfg)
    self.weather = synthetic.Weather(self.cfg, self.stats, self.device)
    self.phases.mark('weights')
    self._request(0)    # warm-up: the graph of these shapes is captured
    self._sync()
    self.phases.mark('warm-up request')

  def _sync(self) -> None:
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)

  def _request(self, r: int) -> torch.Tensor:
    """Request r: [members, lat, lon, C_t] on the host."""
    with torch.profiler.record_function('perfbench.request'):
      inputs, _, forcings = self.weather.window(
          seeds.derive(self.seed, seeds.DATA, r))
      out = self.rollout(
          self.prog.stack, inputs[None], forcings[None, None],
          seed=seeds.derive(self.seed, seeds.MEMBERS, r),
          num_members=self.members, member_chunk=self.chunk, jit=True)
    return out[:, 0, 0]

  # --- the window ---

  def unit(self) -> None:
    """One request of the window (requests 1, 2, ...; 0 warmed up)."""
    self.attempted += self.members
    self.outputs.append(self._request(len(self.outputs) + 1))

  def window(self, seconds: float) -> Dict[str, float]:
    self._sync()
    t0 = time.perf_counter()
    end = t0
    while end - t0 < seconds:
      self.unit()
      end = time.perf_counter()
    return {'forecast_member_steps_per_s':
            self.members * len(self.outputs) / (end - t0)}

  # --- what the readers need ---

  def flops_per_unit(self, graph: graph_lib.Graph) -> float:
    return flops.forecast_step(self.cfg, graph, self.members)

  def attention_launch(self, graph: graph_lib.Graph) -> dict:
    """The shape of each block-sparse attention launch, per kernel."""
    c = self.cfg
    return {'A': dict(batch=self.chunk, nodes=graph.num_mesh,
                      heads=c['num_heads'],
                      head_dim=c['d_model'] // c['num_heads'],
                      pairs=graph.attention_pairs)}

  def free(self) -> None:
    self.prog = self.weather = None

  # --- the check ---

  def sample(self) -> List[tuple]:
    """(request, member) pairs to check: one request that ended, drawn
    from the seed, and one member from each half of its batch."""
    r = seeds.rng(self.seed, seeds.CHECK)
    req = int(r.integers(len(self.outputs)))
    half = max(self.members // 2, 1)
    members = [int(r.integers(half))]
    if self.members > 1:
      members.append(half + int(r.integers(self.members - half)))
    return [(req, m) for m in members]

  def check(self, graph: graph_lib.Graph,
            precision: Optional[ref.Precision] = None,
            every: bool = False) -> List[Comparison]:
    precision = precision or ref.Precision('f32')
    dev = self.device
    model = ref.Wrapped(self.cfg, graph, self.weights, self.stats,
                        precision, dev)
    noise = ref.SphereNoise(graph.grid_lat, graph.grid_lon, dev)
    weather = synthetic.Weather(self.cfg, self.stats, dev)
    got, want = [], []
    for req, m in self.sample():
      inputs, _, forcings = weather.window(
          seeds.derive(self.seed, seeds.DATA, req + 1))
      gen = ref.keyed_generator(
          seeds.derive(self.seed, seeds.MEMBERS, req + 1), m, device=dev)
      answer = ref.sample_member(model, noise, inputs, forcings, gen)
      # Both in the sampler's space: normalized residuals.
      want.append(model.normalized_prediction(inputs, answer))
      got.append(model.normalized_prediction(
          inputs, self.outputs[req][m].to(dev)))
    return [Comparison('forecast_rel_l2', relative_l2(
        torch.stack(got), torch.stack(want)),
        self.params['limits']['forecast_rel_l2'])]

