"""Where the device time of a training step or a denoiser call goes, on
one card.

    python -m gencast_tpu_torch.training.profile_step [--preset 0.25deg] \
        [--model gencast|graphcast] [--mode train|denoise|sample|predict] \
        [--steps 3] [--steps_per_call K] [--eager] [--trace PATH]

Sets up the preset's run as the training CLI does (`--data synthetic
--clean_sst_nans`, seed 0) and packs the batches. `--mode train` takes one
warm-up training step, then runs `--steps` training steps under
torch.profiler; with `--steps_per_call K` (> 1) the steps are the training
CLI's fused ones (`steps.scanned_train_steps`, K per call over a device
pool: replays of one CUDA graph), after one warm-up call that captures the
graph. `--mode denoise` does the same with eager, undifferentiated calls
of the wrapped denoiser (the serving stack, bf16 where the preset is) at
noise level 1; `--mode sample` with forecast steps of the serving stack,
one `sample` each: its 2N - 1 denoiser calls replay the model's CUDA graph,
with the sampler's eager ops between them (per-call figures are the step's
over its calls). `--model graphcast` profiles GraphCast (the preset's grid,
mesh and widths with GraphCast's variables: at 1deg GraphCast_small) in
`--mode train` (per-step or fused, as above) or `--mode predict`: forward
steps of the serving stack, each a replay of the model's CUDA graph, or
with `--eager` eager forwards. Prints seconds per step or call (host
clock, unprofiled and profiled), device time per step, the device's busy
share of the profiled window (device activity over wall time; the work
runs on one stream) and of the unprofiled wall, the model FLOPs of a step
or call (`training/flops.py`) with the model TFLOP/s and MFU they give
over the unprofiled seconds (against the H100 SXM's dense bf16 peak, beside
the card's name and power limit), the device time of each
of the port's kernels and of the other kernel families, and the ten
costliest kernels, and the peak of allocated device memory. `--trace` writes the
profiler's Chrome trace. With
GENCAST_SPARSE_FUSED_BWD=1 in the environment the 1-degree step runs the
fused attention backward (kernel G and its dq reduce) instead of kernel F.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch

# Kernel families by a part of the kernel's name, first match wins (A, C, D,
# F and G have a float32 kernel, `..._kernel`, and a bf16 one,
# `..._mma_kernel`).
_FAMILIES = (
    ('D-dk/dv', 'banded_attention_dkv_'),
    ('D-dq', 'banded_attention_dq_'),
    ('C', 'banded_attention_fwd_'),
    ('G', 'sparse_attention_dkvq_'),
    ('G dq reduce', 'sparse_attention_dq_reduce_'),
    ('F-dk/dv', 'sparse_attention_dkv_'),
    ('F-dq', 'sparse_attention_dq_'),
    ('A', 'sparse_attention_fwd_'),
    ('E', 'ln_film_'),
    ('B', 'segment_sum_kernel'),
    ('cuBLAS matmuls', 'gemm'),
    ('cuBLAS matmuls', 'sm90_xmma'),
    ('cuBLAS matmuls', 'nvjet'),
    ('reductions', 'reduce_kernel'),
    ('elementwise', 'elementwise_kernel'),
)


def family(name: str) -> str:
  """The family of kernel `name` (`_FAMILIES`; 'other' where none matches)."""
  return next((f for f, part in _FAMILIES if part in name), 'other')


def session_kernels(prof) -> list:
  """(name, ms) of each kernel and copy the torch.profiler session `prof`
  recorded on the device. A user annotation (such as the optimizer's step)
  also appears on the device timeline, as a span over kernels that are
  counted themselves, and does not count."""
  return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation]


def trace_kernels(path: str) -> list:
  """(name, ms) of each kernel and copy in the Chrome trace at `path` (as
  `utils.stop_profiler` writes it); host events and device-track
  annotations do not count."""
  with open(path) as f:
    events = json.load(f)['traceEvents']
  return [(e.get('name', '?'), e.get('dur', 0) / 1e3) for e in events
          if e.get('ph') == 'X'
          and e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]


def breakdown(kernels) -> dict:
  """Device time of (name, ms) records by kernel family and by kernel name:
  {'total_ms', 'families': {family: [ms, launches]}, 'kernels': {name:
  [ms, launches]}}."""
  by_name = collections.defaultdict(lambda: [0.0, 0])
  for name, ms in kernels:
    by_name[name][0] += ms
    by_name[name][1] += 1
  families = collections.defaultdict(lambda: [0.0, 0])
  for name, (ms, count) in by_name.items():
    families[family(name)][0] += ms
    families[family(name)][1] += count
  return {'total_ms': sum(ms for ms, _ in by_name.values()),
          'families': dict(families), 'kernels': dict(by_name)}


def print_breakdown(b: dict, label: str, n: int = 1, top: int = 10) -> None:
  """Prints `breakdown` `b` over `n` units (label: 'per training step',
  ...): each family's device ms, share and launches, then the `top`
  costliest kernels."""
  print(f'[profile] {label}: family, device ms, share, launches')
  for fam, (ms, count) in sorted(b['families'].items(),
                                 key=lambda kv: -kv[1][0]):
    print(f'[profile]   {fam}: {ms / n:.3f} ms, '
          f'{100 * ms / b["total_ms"]:.1f}%, {count / n:g}')
  print(f'[profile] {top} costliest kernels {label}: device ms, launches, '
        'name')
  for name, (ms, count) in sorted(b['kernels'].items(),
                                  key=lambda kv: -kv[1][0])[:top]:
    print(f'[profile]   {ms / n:.3f} ms, {count / n:g}, {name[:120]}')


def model_flops(model: str, mode: str, spec, run, batch: int) -> float:
  """Model FLOPs (training/flops.py) of one unit `main` reports per: a
  training step, a denoiser call (also in sample mode) or a forward step,
  of the run `train.setup` built from `spec`."""
  from gencast_tpu_torch.training import flops
  if model == 'graphcast':
    forward = flops.graphcast_forward_flops(spec, run.statics, batch,
                                            task=run.model.task)
  else:
    forward = flops.denoiser_forward_flops(spec, run.statics, batch)
  return (flops.train_step_flops(forward) if mode == 'train'
          else forward).total


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--preset', default='1deg',
                 help='tiny, nano, 1deg or 0.25deg')
  p.add_argument('--model', default='gencast',
                 choices=('gencast', 'graphcast'))
  p.add_argument('--mode', default='train',
                 choices=('train', 'denoise', 'sample', 'predict'))
  p.add_argument('--eager', action='store_true',
                 help='predict mode: eager forwards instead of replays')
  p.add_argument('--steps', type=int, default=3)
  p.add_argument('--steps_per_call', type=int, default=1,
                 help='train mode: K > 1 profiles fused steps, K per call')
  p.add_argument('--trace', default=None,
                 help='write the Chrome trace of the profiled steps here')
  p.add_argument('--stats_path', default=None,
                 help="the training CLI's --stats_path: an npz of "
                      'normalization stats, loaded when it exists, else '
                      'computed from the data and written there')
  args = p.parse_args(argv)
  modes = (('train', 'predict') if args.model == 'graphcast'
           else ('train', 'denoise', 'sample'))
  if args.mode not in modes:
    p.error(f'--model {args.model} takes --mode {" or ".join(modes)}')
  if not torch.cuda.is_available():
    raise SystemExit('profile_step: needs a CUDA card')
  from gencast_tpu_torch import utils
  from gencast_tpu_torch.training import flops
  from gencast_tpu_torch.training import steps as steps_lib
  from gencast_tpu_torch.training import train

  targs = train.parse_args(
      ['--model', args.model, '--preset', args.preset, '--data',
       'synthetic', '--clean_sst_nans', '--steps', str(args.steps + 1)]
      + (['--stats_path', args.stats_path] if args.stats_path else []))
  run = train.setup(targs)
  wrapped, optimizer, device = run.wrapped, run.optimizer, run.device
  generator = train.step_generator(targs.seed, 0, device)
  batches = [{k: torch.as_tensor(v).to(device)
              for k, v in next(run.batches).items()}
             for _ in range(args.steps + 1)]
  k_call = args.steps_per_call if args.mode == 'train' else 1
  if k_call > 1 and args.steps % k_call:
    raise SystemExit('profile_step: --steps must be a multiple of '
                     '--steps_per_call')
  if k_call > 1:
    pool = train.device_pool(run.source, len(batches), device)
    fused = steps_lib.scanned_train_steps(wrapped, optimizer)
    taken = [0]  # fused steps so far: their global step numbers
  calls = ((2 * run.model.sampler_config.num_noise_levels - 1)
           if args.mode == 'sample' else 1)

  def step(batch):
    if k_call > 1:
      first = taken[0]
      taken[0] += k_call
      fused(pool, [i % len(batches) for i in range(first, first + k_call)],
            range(first, first + k_call), targs.seed)
      return
    if args.mode == 'train':
      steps_lib.train_step(wrapped, optimizer, batch['inputs'],
                           batch['targets'], batch['forcings'], generator)
      return
    if args.mode == 'sample':
      wrapped.sample(batch['inputs'], batch['forcings'], generator)
      return
    if args.mode == 'predict':
      with torch.no_grad():
        wrapped.predict(batch['inputs'], batch['forcings'],
                        graphed=not args.eager)
      return
    sigma = torch.ones(batch['inputs'].shape[0], device=device)
    with torch.no_grad():
      wrapped(batch['inputs'], batch['targets'], sigma, batch['forcings'])

  # Warm-up: builds the kernels, settles the allocator, captures the graph.
  torch.cuda.reset_peak_memory_stats(device)
  step(batches[0])
  profiled = batches[1:1 + args.steps // k_call]
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for batch in profiled:
    step(batch)
  torch.cuda.synchronize()
  unprofiled = time.perf_counter() - t0
  prof = utils.start_profiler(cuda=True)
  t0 = time.perf_counter()
  for batch in profiled:
    step(batch)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  utils.stop_profiler(prof, args.trace)
  kernels = session_kernels(prof)
  if not kernels:
    raise SystemExit('profile_step: the profiler recorded no device activity')
  b = breakdown(kernels)
  device_ms = b['total_ms']
  # Per training step (K per fused call) or forecast step, then per
  # denoiser call in sample mode.
  n = len(profiled) * k_call * calls
  card = utils.card_line()
  what = {'train': 'training step', 'denoise': 'denoiser call',
          'sample': 'denoiser call', 'predict': 'forward step'}[args.mode]
  how = {'train': (f', fused, {k_call} per call (CUDA-graph replays)'
                   if k_call > 1 else ', eager'),
         'denoise': ', eager', 'sample': (
             f' in forecast steps of {calls} (CUDA-graph replays)'),
         'predict': (', eager' if args.eager
                     else ' (CUDA-graph replays)')}[args.mode]
  print(f'[profile] {card}; {args.model} {args.preset} {what}{how}, {n} '
        f'profiled: {unprofiled / n:.4f} s each unprofiled, '
        f'{wall / n:.4f} s profiled (host clock), {device_ms / n:.2f} ms of device time each, device '
        f'busy {100 * device_ms / (1e3 * wall):.1f}% of the profiled window, '
        f'{100 * device_ms / (1e3 * unprofiled):.1f}% of the unprofiled wall')
  per_unit = model_flops(args.model, args.mode, train.build_spec(targs), run,
                         targs.batch_size)
  print(f'[profile] {per_unit:.4e} model FLOPs per {what}: '
        f'{per_unit * n / unprofiled / 1e12:.1f} TFLOP/s, MFU '
        f'{100 * flops.mfu(per_unit * n, unprofiled):.2f}% of the H100 SXM '
        f'dense bf16 peak over the unprofiled seconds; {card}')
  print(f'[profile] peak allocated device memory '
        f'{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB (the '
        f'model, its optimizer state, {len(batches)} batches and the steps)')
  print_breakdown(b, f'per {what}', n)
  if args.trace:
    print(f'[profile] trace written to {args.trace}')


if __name__ == '__main__':
  main()
