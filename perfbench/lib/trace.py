"""The traced window: one torch.profiler recording (host and device
activity) over whole requests or steps, and what the per-layer readers
take from it.

The window is the span `perfbench.window`, opened and closed on a
synchronized device, so its wall holds all the work started in it. Device
time is the union of the intervals in which a kernel, copy or set ran:
overlapping kernels count once, and the idle share is one minus that
union over the window's wall (not kernel time over the wall of another,
untraced run, which can read above 100%). An idle gap is attributed to the
innermost host operation running at its middle. Where the host runs one of
the profiler's own operations (its activity buffers) in an idle gap, the
device waits for the profiler, not for the program: the idle share leaves
that time out of the idle time and out of the wall alike.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Tuple

import torch

from perfbench.lib import families

WINDOW_SPAN = 'perfbench.window'
# Host operations of the profiler itself, as its trace names them.
PROFILER_OPS = frozenset({'Activity Buffer Request', 'Buffer Flush'})


def _merged(spans) -> List[Tuple[float, float]]:
  out: List[List[float]] = []
  for s, e in sorted(spans):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return [(s, e) for s, e in out]


def _overlap(a, b) -> float:
  """Length of the intersection of two sorted lists of disjoint spans."""
  i = j = 0
  total = 0.0
  while i < len(a) and j < len(b):
    lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
    total += max(0.0, hi - lo)
    if a[i][1] < b[j][1]:
      i += 1
    else:
      j += 1
  return total


class Trace:
  """Device and host events of the traced window, in microseconds."""

  def __init__(self):
    self.kernels: List[Tuple[float, float, str]] = []   # start, end, name
    self.host: List[Tuple[float, float, str]] = []
    self.window: Tuple[float, float] = (0.0, 0.0)
    self.wall_s = 0.0
    self.units = 0

  @contextlib.contextmanager
  def record(self):
    """Profiles the body: host and device activity, the window span."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=activities)
    torch.cuda.synchronize()
    prof.start()
    try:
      with torch.profiler.record_function(WINDOW_SPAN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield self
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - t0
    finally:
      prof.stop()
    self._read(prof.events())

  def _read(self, events) -> None:
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
      span = (e.time_range.start, e.time_range.end)
      if e.device_type == cuda:
        if not e.is_user_annotation:
          self.kernels.append((span[0], span[1], e.name))
      elif e.name == WINDOW_SPAN:
        self.window = span
      else:
        self.host.append((span[0], span[1], e.name))
    lo, hi = self.window
    self.kernels = sorted((max(s, lo), min(e, hi), n)
                          for s, e, n in self.kernels if e > lo and s < hi)

  @property
  def window_s(self) -> float:
    return (self.window[1] - self.window[0]) * 1e-6

  def busy_intervals(self) -> List[Tuple[float, float]]:
    return _merged((s, e) for s, e, _ in self.kernels)

  def busy_s(self) -> float:
    return sum(e - s for s, e in self.busy_intervals()) * 1e-6

  def _gaps(self) -> List[Tuple[float, float]]:
    lo, hi = self.window
    edges = [lo] + [t for iv in self.busy_intervals() for t in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

  def profiler_idle_s(self) -> float:
    """Idle seconds in which the host ran the profiler's own
    operations."""
    lo, hi = self.window
    ops = _merged((max(s, lo), min(e, hi)) for s, e, n in self.host
                  if n in PROFILER_OPS and e > lo and s < hi)
    return _overlap(self._gaps(), ops) * 1e-6

  def idle_share(self) -> float:
    """Idle share of the window (%), the profiler's own time left out."""
    stolen = self.profiler_idle_s()
    return 100.0 * (1.0 - self.busy_s() / (self.window_s - stolen))

  def device_seconds(self) -> Dict[str, float]:
    """Device seconds by operation name (overlaps counted per kernel)."""
    out = collections.defaultdict(float)
    for s, e, n in self.kernels:
      out[n] += (e - s) * 1e-6
    return dict(out)

  def launches(self) -> Dict[str, int]:
    """Device operations by name, counted."""
    return dict(collections.Counter(n for _, _, n in self.kernels))

  def family_seconds(self) -> Dict[str, float]:
    out = collections.defaultdict(float)
    for n, sec in self.device_seconds().items():
      out[families.family(n)] += sec
    return dict(out)

  def idle_gaps(self) -> List[Tuple[str, float]]:
    """(host operation, seconds) of every gap between device activity in
    the window, longest first."""
    gaps = self._gaps()
    host = sorted(self.host)
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:64]:
      mid = (s + e) / 2
      running = [h for h in host if h[0] <= mid <= h[1]]
      name = (min(running, key=lambda h: h[1] - h[0])[2] if running
              else 'no host operation')
      out.append((name, (e - s) * 1e-6))
    return out

  def breakdown(self, top: int = 10) -> dict:
    ops = sorted(self.device_seconds().items(), key=lambda kv: -kv[1])
    named = [[f'{families.family(n)}: {n[:160]}', s] for n, s in ops[:top]]
    return {'device_ops': named, 'idle_gaps': [
        [n[:160], s] for n, s in self.idle_gaps()[:top]]}
