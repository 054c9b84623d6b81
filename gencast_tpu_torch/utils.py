"""Observability utilities: profiling traces, the program's spans, and the
sampler fixture.

Counterpart of `gencast_tpu.utils`: `sampler_fixture` builds the serving
model, its inputs and a one-forecast-step sampler; `start_profiler` and
`stop_profiler` are the torch.profiler session of every profiling path
(`profile_trace` as a context, `training/profile_step.py`, the training
CLI's `--profile_dir`); `span` and `gradient_mark` record the program's
layer boundaries (`SPANS`) into that session; `card_line` names the card a
number was taken on.

Spans. A CUDA graph replays the kernels it captured and none of the host
annotations made while it was captured, and a forecast's denoiser call or a
training step is one replay. So a span that bounds device work is marked
on the device: its begin and end are empty kernels (`csrc/span_mark.cu`,
named `gt_span_<span>_<edge>`) launched on the current stream whether or
not a profiler records, which the graphs captured at set-up hold and every
replay runs, on the device trace's clock. A gradient mark opens a layer's
gradient region in the backward pass; the region ends at the next gradient
mark or at the end of the `backward` span. Non-reentrant checkpoints stop
their recomputation early, so a `remat` region recomputed in the backward
pass may have no end mark. A host span is a torch.profiler span
`gencast.<span>` (with the unit it belongs to, e.g. `gencast.train.stage
step=12`), entered only while a profiler records; otherwise a span costs a
flag read. On the CPU a mark is, while a profiler records, a zero-length
host span of the kernel's name. `perfbench/lib/spans.py` reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
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


@dataclasses.dataclass(frozen=True)
class Span:
  """A layer boundary of the program. `host`: a torch.profiler span while a
  profiler records; `device`: begin and end marks on the device;
  `gradient`: a gradient mark opens its gradient region; `parent`: the span
  whose gradient region holds that region."""
  name: str
  host: bool = False
  device: bool = False
  gradient: bool = False
  parent: Optional[str] = None


# The span table (PERF.md section 3's layers).
SPANS = (
    # GenCast._precond_denoise: preconditioning, input assembly, casts.
    Span('denoiser', device=True, gradient=True),
    # DenoiserArchitecture.forward: run_g2m, the processor, run_m2g.
    Span('grid2mesh', device=True, gradient=True, parent='denoiser'),
    Span('processor', device=True, gradient=True, parent='denoiser'),
    Span('mesh2grid', device=True, gradient=True, parent='denoiser'),
    # GenCast.sphere_noise (ops.sph_harm): the sampler's and training's draws.
    Span('noise', host=True, device=True),
    # nn.remat.checkpoint's recomputed function, in both passes.
    Span('remat', device=True),
    # loss.backward() of a training step; Optimizer.apply (clip, AdamW).
    Span('backward', device=True),
    Span('optimizer', device=True),
    # FusedTrainSteps: the address check and a step's staging; its replay.
    Span('train.stage', host=True),
    Span('train.replay', host=True),
    # The sampler's denoiser call (load, replay); a member chunk's
    # rollout; a CUDA graph's capture.
    Span('sample.call', host=True),
    Span('ensemble.rollout', host=True),
    Span('graph.capture', host=True),
)
_TABLE = {s.name: s for s in SPANS}
# Host spans are named HOST_PREFIX + the span's name.
HOST_PREFIX = 'gencast.'
# The device marks, (span, edge), in the order of csrc/span_mark.cu.
MARKS = tuple((s.name, edge) for s in SPANS if s.device
              for edge in ('begin', 'end') + (('grad',) * s.gradient))
_MARK_INDEX = {m: i for i, m in enumerate(MARKS)}


def mark_name(span: str, edge: str) -> str:
  """The mark's kernel name (and its host span's on the CPU)."""
  return f'gt_span_{span}_{edge}'


def profiling() -> bool:
  """Whether a torch.profiler session records in this process."""
  return torch._C._autograd._profiler_enabled()


def mark(span: str, edge: str, device: torch.device) -> None:
  """Mark (span, edge) on `device`: its kernel on the current stream of a
  CUDA device, always; on the CPU a zero-length host span of the same name
  while a profiler records."""
  if device.type == 'cuda':
    from gencast_tpu_torch.ops import cuda_lib
    cuda_lib.span_mark(_MARK_INDEX[(span, edge)], device)
  elif profiling():
    with torch.profiler.record_function(mark_name(span, edge)):
      pass


class span:
  """`with span(name, device, unit):` records span `name` of SPANS around
  the block: its host span while a profiler records (`unit`, e.g.
  'step=12', ties the spans of one unit of work together), its begin mark
  on `device` before the block and its end mark after it, unless the block
  raised."""

  def __init__(self, name: str, device: Optional[torch.device] = None,
               unit: Optional[str] = None):
    self.entry = _TABLE[name]
    self.device = device
    self.unit = unit
    self.host = None

  def __enter__(self):
    if self.entry.host and profiling():
      label = HOST_PREFIX + self.entry.name
      if self.unit is not None:
        label = f'{label} {self.unit}'
      self.host = torch.profiler.record_function(label)
      self.host.__enter__()
    if self.entry.device:
      mark(self.entry.name, 'begin', self.device)
    return self

  def __exit__(self, *exc):
    if self.entry.device and exc[0] is None:
      mark(self.entry.name, 'end', self.device)
    if self.host is not None:
      self.host.__exit__(*exc)
    return False


class _GradientMark(torch.autograd.Function):
  """The identity; its backward launches a span's gradient mark when the
  gradients of its outputs arrive: the layer's gradient begins."""

  @staticmethod
  def forward(ctx, name, *tensors):
    ctx.name = name
    ctx.device = tensors[0].device
    ctx.set_materialize_grads(False)
    return tensors

  @staticmethod
  def backward(ctx, *grads):
    mark(ctx.name, 'grad', ctx.device)
    return (None,) + grads


def gradient_mark(name: str, *tensors: torch.Tensor):
  """`tensors` (one tensor where one is given), leaving layer `name`: where
  autograd records them, through `_GradientMark`. Do not modify the
  results in place: autograd refuses that on a custom function's views."""
  if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
    tensors = _GradientMark.apply(name, *tensors)
  return tensors[0] if len(tensors) == 1 else tuple(tensors)
