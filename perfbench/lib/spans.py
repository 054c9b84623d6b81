"""The program's spans in the traced window: device time by layer.

The program marks each layer boundary on the device with an empty kernel,
`gt_span_<span>_<edge>` (`gencast_tpu_torch/utils.py`, `csrc/span_mark.cu`),
launched on the stream of the work it bounds, so the CUDA graphs captured
at set-up hold the marks and every replay runs them on the device trace's
clock. This module keeps a frozen copy of the program's span table
(`SPANS`; a CPU test holds it to the program's) and segments the window's
device operations with a stack of marks:

- A begin mark opens its span, an end mark closes the innermost open one
  of its name. Each operation goes to the innermost span open when it
  starts; a span's device seconds are those of the operations inside it,
  nested spans included (a layer's share holds its forward, its gradient
  and its recomputation).
- A gradient mark opens its layer's gradient region in the backward pass,
  inside its parent's (the three denoiser layers in the denoiser's). The
  region ends at the next gradient mark that is not its child's, or at the
  end of the `backward` span: the model's input data carries no gradient,
  so nothing marks the end of `grid2mesh`'s gradient.
- Non-reentrant checkpoints stop their recomputation early, so a `remat`
  begin in the backward pass may have no end mark, and where the
  recomputation ends cannot be seen. Those marks are counted and open no
  region: the backward's operations stay in the layers' gradient regions,
  and `remat` regions are the forward pass's (what the backward pays
  again, up to the early-stopped tail).
- The program computes on one stream. A copy that overlaps a kernel in
  time ran on another stream (`rollout.py`'s side-stream offload) and goes
  to no layer.

Shares divide by all device seconds of the window, as `elementwise_share`
does, so the top-level spans, the work outside every span and the other
streams' copies add up to 100%. A trace without the span's marks (a program without spans) gives
None, not 0.
"""

from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, List, Optional, Tuple

from perfbench.lib import families
from perfbench.lib.trace import PROFILER_OPS, Trace, _merged

# The program's span table: (name, host, device, gradient, parent), as
# `gencast_tpu_torch.utils.SPANS` has it (frozen).
SPANS = (
    ('denoiser', False, True, True, None),
    ('grid2mesh', False, True, True, 'denoiser'),
    ('processor', False, True, True, 'denoiser'),
    ('mesh2grid', False, True, True, 'denoiser'),
    ('noise', True, True, False, None),
    ('remat', False, True, False, None),
    ('backward', False, True, False, None),
    ('optimizer', False, True, False, None),
    ('train.stage', True, False, False, None),
    ('train.replay', True, False, False, None),
    ('sample.call', True, False, False, None),
    ('ensemble.rollout', True, False, False, None),
    ('graph.capture', True, False, False, None),
)
HOST_PREFIX = 'gencast.'
PARENT = {name: parent for name, _, _, _, parent in SPANS}
# Mark kernel name -> (span, edge).
MARKS = {f'gt_span_{name}_{edge}': (name, edge)
         for name, _, device, gradient, _ in SPANS if device
         for edge in ('begin', 'end') + (('grad',) * gradient)}
CHILDREN = {'denoiser': ('grid2mesh', 'processor', 'mesh2grid')}

OUTSIDE = 'outside'            # in no program span
GRAD = 'gradient'
FORWARD = 'forward'

Entry = Tuple[str, str]        # (span, FORWARD or GRAD)


def _is_copy(name: str) -> bool:
  return name.startswith(('Memcpy', 'Memset'))


def _inside(stack: List[Entry], name: str) -> bool:
  return any(span == name for span, _ in stack)


class Segmented:
  """The window's device operations by the stack of spans open at each:
  `seconds[path]` sums the operations whose stack was `path` (a tuple of
  entries, outermost first; () for OUTSIDE), `other_stream_s` the copies
  of other streams; `marks[(span, edge, pass)]` counts the marks ('forward'
  or 'backward' pass), `mark_s` their own device seconds; `by_name[(path,
  name)]` the seconds by operation name."""

  def __init__(self, kernels):
    self.seconds: Dict[Tuple[Entry, ...], float] = collections.defaultdict(
        float)
    self.by_name: Dict[tuple, float] = collections.defaultdict(float)
    self.marks: Dict[tuple, int] = collections.Counter()
    self.mark_s = 0.0
    self.other_stream_s = 0.0
    self.total_s = 0.0
    ops = sorted(kernels)
    compute = _merged((s, e) for s, e, n in ops if not _is_copy(n))
    starts = [s for s, _ in compute]
    stack: List[Entry] = []
    for s, e, name in ops:
      sec = (e - s) * 1e-6
      self.total_s += sec
      mark = MARKS.get(name)
      if mark is not None:
        self.mark_s += sec
        self._add(self._mark(stack, *mark), name, sec)
        continue
      if _is_copy(name) and _overlaps(compute, starts, s, e):
        self.other_stream_s += sec
        continue
      self._add(tuple(stack), name, sec)

  def _add(self, path, name: str, sec: float) -> None:
    self.seconds[path] += sec
    self.by_name[(path, name)] += sec

  def _mark(self, stack: List[Entry], span: str,
            edge: str) -> Tuple[Entry, ...]:
    """Applies a mark to the stack; returns the path its own device time
    goes to: inside the span it opens or ends."""
    backward = _inside(stack, 'backward')
    self.marks[(span, edge, 'backward' if backward else 'forward')] += 1
    if span == 'remat' and backward:
      return tuple(stack)      # a recomputation: counted, opens nothing
    if edge == 'begin':
      stack.append((span, FORWARD))
    elif edge == 'end':
      for i in range(len(stack) - 1, -1, -1):
        if stack[i] == (span, FORWARD):
          path = tuple(stack[:i + 1])
          del stack[i:]
          return path
    else:
      parent = (PARENT[span], GRAD)
      while stack and stack[-1][1] == GRAD and stack[-1] != parent:
        stack.pop()
      stack.append((span, GRAD))
    return tuple(stack)

  # --- what the readers take ---

  def seen(self, span: str) -> bool:
    """Whether the window holds any mark of `span`."""
    return any(s == span for s, _, _ in self.marks)

  def inclusive_s(self, span: str) -> float:
    """Device seconds inside `span` (its forward or gradient region),
    nested spans included."""
    return sum(sec for path, sec in self.seconds.items()
               if any(name == span for name, _ in path))

  def self_s(self, span: str) -> float:
    """Device seconds inside `span` and none of its CHILDREN."""
    kids = CHILDREN.get(span, ())
    return sum(sec for path, sec in self.seconds.items()
               if any(n == span for n, _ in path)
               and not any(n in kids for n, _ in path))

  def innermost_s(self, span: str) -> float:
    """Device seconds whose innermost open span is `span`."""
    return sum(sec for path, sec in self.seconds.items()
               if path and path[-1][0] == span)

  def outside_s(self) -> float:
    """Device seconds in no program span, other streams' copies included."""
    return self.seconds.get((), 0.0) + self.other_stream_s

  def share(self, seconds: float) -> Optional[float]:
    return 100.0 * seconds / self.total_s if self.total_s > 0 else None

  def by_layer(self, key=None) -> Dict[Tuple[str, str], float]:
    """{(key(operation name), layer): seconds}, by default by `family`:
    the layer is the innermost open span that is not `remat` (`remat`
    where it is the only one; OUTSIDE where none is open)."""
    key = key or family
    out = collections.defaultdict(float)
    for (path, name), sec in self.by_name.items():
      layers = [n for n, _ in path if n != 'remat'] or [n for n, _ in path]
      out[(key(name), layers[-1] if layers else OUTSIDE)] += sec
    return dict(out)


def family(name: str) -> str:
  """The kernel family (`families`), 'span marks' for the marks."""
  return 'span marks' if name in MARKS else families.family(name)


def _overlaps(merged, starts, s: float, e: float) -> bool:
  """Whether [s, e] overlaps one of the sorted disjoint intervals."""
  i = bisect.bisect_left(starts, e)
  return i > 0 and merged[i - 1][1] > s


def segmented(trace: Trace) -> Segmented:
  """The trace's segmentation, made once per trace."""
  cached = getattr(trace, '_spans', None)
  if cached is None:
    cached = Segmented(trace.kernels)
    trace._spans = cached
  return cached


# --- the readers of the per-layer metrics ---

def _segments(ctx, kind: str) -> Optional[Segmented]:
  return segmented(ctx.trace) if ctx.of(kind) else None


def layer_share(ctx, kind: str, span: str) -> Optional[float]:
  """Share (%) of the window's device seconds inside `span`."""
  seg = _segments(ctx, kind)
  if seg is None or not seg.seen(span):
    return None
  return seg.share(seg.inclusive_s(span))


def self_share(ctx, kind: str, span: str) -> Optional[float]:
  """Share (%) inside `span` and outside its CHILDREN."""
  seg = _segments(ctx, kind)
  if seg is None or not seg.seen(span):
    return None
  return seg.share(seg.self_s(span))


def host_spans(trace: Trace, span: str) -> List[Tuple[float, float, str]]:
  """The window's host spans of `span` (`gencast.<span>`, with or without
  a unit after a space)."""
  name = HOST_PREFIX + span
  lo, hi = trace.window
  return [(s, e, n) for s, e, n in trace.host
          if (n == name or n.startswith(name + ' ')) and s >= lo and e <= hi]


def host_median_ms(ctx, kind: str, span: str) -> Optional[float]:
  """Median host duration (ms) of the window's `span` host spans."""
  if not ctx.of(kind):
    return None
  found = host_spans(ctx.trace, span)
  if not found:
    return None
  return statistics.median(e - s for s, e, _ in found) * 1e-3


# --- idle time by program host span (the tool's) ---

def _subtract(gaps, holes) -> List[Tuple[float, float]]:
  """Sorted disjoint `gaps` less the sorted disjoint `holes`."""
  out, j = [], 0
  for s, e in gaps:
    while j < len(holes) and holes[j][1] <= s:
      j += 1
    k, cur = j, s
    while k < len(holes) and holes[k][0] < e:
      if holes[k][0] > cur:
        out.append((cur, holes[k][0]))
      cur = max(cur, holes[k][1])
      k += 1
    if cur < e:
      out.append((cur, e))
  return out


def _innermost_timeline(spans) -> List[Tuple[float, float, str]]:
  """Disjoint (start, end, name) pieces: at each time the innermost (latest
  begun) of the host spans running then."""
  edges = sorted({t for s, e, _ in spans for t in (s, e)})
  starts = sorted(spans)
  active: List[Tuple[float, float, str]] = []
  out, i = [], 0
  for a, b in zip(edges, edges[1:]):
    while i < len(starts) and starts[i][0] <= a:
      active.append(starts[i])
      i += 1
    active = [x for x in active if x[1] > a]
    if active:
      out.append((a, b, max(active)[2]))
  return out


def idle_by_host_span(trace: Trace) -> Dict[str, float]:
  """Idle seconds of the window (no device operation running, the host's
  time in the profiler's own operations left out, as `idle_share` leaves
  it out) by the innermost program host span running then (its name
  without the unit), or OUTSIDE where none is."""
  lo, hi = trace.window
  bounds = [lo] + [t for iv in trace.busy_intervals() for t in iv] + [hi]
  gaps = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2)
          if bounds[i + 1] > bounds[i]]
  ops = _merged((max(s, lo), min(e, hi)) for s, e, n in trace.host
                if n in PROFILER_OPS and e > lo and s < hi)
  gaps = _subtract(gaps, ops)
  program = [(s, e, n.split(' ', 1)[0][len(HOST_PREFIX):])
             for s, e, n in trace.host if n.startswith(HOST_PREFIX)]
  out = collections.defaultdict(float)
  pieces = _innermost_timeline(program)
  i = j = 0
  while i < len(gaps) and j < len(pieces):
    s, e = max(gaps[i][0], pieces[j][0]), min(gaps[i][1], pieces[j][1])
    if e > s:
      out[pieces[j][2]] += (e - s) * 1e-6
    if gaps[i][1] < pieces[j][1]:
      i += 1
    else:
      j += 1
  out[OUTSIDE] = sum(e - s for s, e in gaps) * 1e-6 - sum(out.values())
  return dict(out)
