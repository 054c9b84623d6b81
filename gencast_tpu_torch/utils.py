"""Observability utilities: profiling traces, throughput meters, and the
sampler fixture.

Counterpart of `gencast_tpu.utils`: `sampler_fixture` builds the serving
model, its inputs and a one-forecast-step sampler; `start_profiler` and
`stop_profiler` are the torch.profiler session of every profiling path
(`profile_trace` as a context, `training/profile_step.py`, the training
CLI's `--profile_dir`); `Throughput` is a smoothed steps-per-second meter;
`card_line` names the card a number was taken on.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
import types
from typing import Optional

import torch

# The Chrome trace `profile_trace` writes into its directory.
TRACE_FILE = 'profile.pt.trace.json'


def card_line() -> str:
  """The card's name and power limit, as `nvidia-smi --query-gpu=name,
  power.limit --format=csv,noheader` gives them (for the line beside every
  number measured on the card)."""
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]


def sampler_fixture(spec, *, rngs_seed: int = 0,
                    device='cuda') -> types.SimpleNamespace:
  """The serving model of `spec` (bf16-wrapped where the spec is), random
  inputs and forcings at batch 1, and a one-forecast-step sampler.

  Weights come from `rngs_seed`; inputs and forcings from one
  torch.Generator on `device` seeded 0, in that order, so no host copy
  precedes a timed step. Returns a namespace with: model (wrapped),
  statics, denoiser, inputs, forcings, generator(seed) (a fresh generator on
  `device`), and sample(inputs, forcings, generator) -> the sum of one
  sampled forecast step (2N - 1 denoiser calls; on the card each replays
  the model's CUDA graph of the call, as the CLIs run them).
  """
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.models import casting, wrappers

  device = torch.device(device)
  model, statics = configs.build_gencast(spec, seed=rngs_seed, device=device)
  if spec.cast_bf16:
    model = casting.Bfloat16Cast(model)
  d = wrappers.find_layout_provider(model)
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  g = torch.Generator(device=device).manual_seed(0)
  inputs = torch.randn(grid + (d.input_layout.num_channels,), generator=g,
                       device=device)
  forcings = torch.randn(grid + (d.forcing_layout.num_channels,),
                         generator=g, device=device)

  def generator(seed: int = 2) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)

  def sample(inputs, forcings, generator):
    return model.sample(inputs, forcings, generator).sum()

  return types.SimpleNamespace(
      model=model, statics=statics, denoiser=d, inputs=inputs,
      forcings=forcings, generator=generator, sample=sample)


def start_profiler(cuda: bool):
  """A started torch.profiler session: host ops, and the card's kernels
  where `cuda`.

  Make it the process's first profiler session: on the card a CUDA session
  that is not its process's first may record fewer kernels than were
  launched.
  """
  activities = [torch.profiler.ProfilerActivity.CPU]
  if cuda:
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  prof = torch.profiler.profile(activities=activities)
  prof.start()
  return prof


def stop_profiler(prof, path: Optional[str]) -> None:
  """Stops `prof` and, unless `path` is None, writes its Chrome trace
  there (view it in Perfetto or chrome://tracing)."""
  prof.stop()
  if path is not None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
  """A `start_profiler` session (CUDA where the card is there) that writes
  its Chrome trace to `log_dir`/TRACE_FILE; a no-op yielding None when
  log_dir is None."""
  if log_dir is None:
    yield None
    return
  prof = start_profiler(torch.cuda.is_available())
  try:
    yield prof
  except BaseException:
    prof.stop()
    raise
  stop_profiler(prof, os.path.join(log_dir, TRACE_FILE))


class Throughput:
  """Steps/sec meter with exponential smoothing, for training loops."""

  def __init__(self, smoothing: float = 0.9):
    self._smoothing = smoothing
    self._last: Optional[float] = None
    self._rate: Optional[float] = None

  def tick(self, steps: int = 1) -> Optional[float]:
    now = time.time()
    if self._last is not None:
      inst = steps / max(now - self._last, 1e-9)
      self._rate = (inst if self._rate is None else
                    self._smoothing * self._rate
                    + (1 - self._smoothing) * inst)
    self._last = now
    return self._rate

  @property
  def rate(self) -> Optional[float]:
    return self._rate
