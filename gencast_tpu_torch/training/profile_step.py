"""Where the device time of a training step or a denoiser call goes, on
one card.

    python -m gencast_tpu_torch.training.profile_step [--preset 1deg] \
        [--mode train|denoise] [--steps 3] [--trace PATH]

Sets up the preset's run as the training CLI does (`--data synthetic
--clean_sst_nans`, seed 0) and packs the batches. `--mode train` takes one
warm-up training step, then runs `--steps` training steps under
torch.profiler; `--mode denoise` does the same with undifferentiated calls
of the wrapped denoiser (the serving stack, bf16 where the preset is) at
noise level 1. Prints seconds per step or call (host clock), device time
per step, the device's busy share of the profiled window (device activity
over wall time; the work runs on one stream), the device time of each of
the port's kernels and of the other kernel families, and the ten costliest
kernels. `--trace` writes the profiler's Chrome trace. With
GENCAST_SPARSE_FUSED_BWD=1 in the environment the 1-degree step runs the
fused attention backward (kernel G) instead of kernel F.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch

# Kernel families by a part of the kernel's name, first match wins (D and F
# have a float32 kernel, `..._kernel`, and a bf16 one, `..._mma_kernel`).
_FAMILIES = (
    ('D-dk/dv', 'banded_attention_dkv_'),
    ('D-dq', 'banded_attention_dq_'),
    ('C', 'banded_attention_fwd_kernel'),
    ('G', 'sparse_attention_dkvq_kernel'),
    ('F-dk/dv', 'sparse_attention_dkv_'),
    ('F-dq', 'sparse_attention_dq_'),
    ('A', 'sparse_attention_fwd_kernel'),
    ('E', 'ln_film_'),
    ('B', 'segment_sum_kernel'),
    ('cuBLAS matmuls', 'gemm'),
    ('cuBLAS matmuls', 'sm90_xmma'),
    ('cuBLAS matmuls', 'nvjet'),
    ('reductions', 'reduce_kernel'),
    ('elementwise', 'elementwise_kernel'),
)


def _family(name: str) -> str:
  return next((f for f, part in _FAMILIES if part in name), 'other')


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--preset', default='1deg', help='tiny, nano or 1deg')
  p.add_argument('--mode', default='train', choices=('train', 'denoise'))
  p.add_argument('--steps', type=int, default=3)
  p.add_argument('--trace', default=None,
                 help='write the Chrome trace of the profiled steps here')
  args = p.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('profile_step: needs a CUDA card')
  from gencast_tpu_torch.training import steps as steps_lib
  from gencast_tpu_torch.training import train

  targs = train.parse_args(['--preset', args.preset, '--data', 'synthetic',
                            '--clean_sst_nans',
                            '--steps', str(args.steps + 1)])
  run = train.setup(targs)
  wrapped, optimizer, device = run.wrapped, run.optimizer, run.device
  generator = train.step_generator(targs.seed, 0, device)
  batches = [{k: torch.as_tensor(v).to(device)
              for k, v in next(run.batches).items()}
             for _ in range(args.steps + 1)]

  def step(batch):
    if args.mode == 'train':
      steps_lib.train_step(wrapped, optimizer, batch['inputs'],
                           batch['targets'], batch['forcings'], generator)
      return
    sigma = torch.ones(batch['inputs'].shape[0], device=device)
    with torch.no_grad():
      wrapped(batch['inputs'], batch['targets'], sigma, batch['forcings'])

  step(batches[0])  # warm-up: builds the kernels, settles the allocator
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    t0 = time.perf_counter()
    for batch in batches[1:]:
      step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  # Kernels and copies only: a user annotation (such as the optimizer's
  # step) also appears on the device timeline, as a span over kernels that
  # are counted themselves.
  device_events = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
  if not device_events:
    raise SystemExit('profile_step: the profiler recorded no device activity')
  by_name = collections.defaultdict(lambda: [0.0, 0])
  for e in device_events:
    by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
    by_name[e.name][1] += 1
  families = collections.defaultdict(lambda: [0.0, 0])
  for name, (ms, count) in by_name.items():
    families[_family(name)][0] += ms
    families[_family(name)][1] += count
  device_ms = sum(ms for ms, _ in by_name.values())
  n = args.steps
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  what = 'training step' if args.mode == 'train' else 'denoiser call'
  print(f'[profile] {card}; {args.preset} {what}, {n} profiled: '
        f'{wall / n:.4f} s each (host clock), {device_ms / n:.2f} ms of '
        f'device time each, device busy {100 * device_ms / (1e3 * wall):.1f}'
        f'% of the window')
  print(f'[profile] per {what}: family, device ms, share, launches')
  for fam, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
    print(f'[profile]   {fam}: {ms / n:.3f} ms, {100 * ms / device_ms:.1f}%, '
          f'{count / n:g}')
  print(f'[profile] ten costliest kernels per {what}: device ms, launches, '
        'name')
  for name, (ms, count) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:10]:
    print(f'[profile]   {ms / n:.3f} ms, {count / n:g}, {name[:120]}')
  if args.trace:
    prof.export_chrome_trace(args.trace)
    print(f'[profile] trace written to {args.trace}')


if __name__ == '__main__':
  main()
