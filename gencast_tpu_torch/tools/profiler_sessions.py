"""Does a torch.profiler session record every kernel launched inside it,
after what ran before it in the same process?

Each case runs in a fresh process: three CUDA profiler sessions of 14
kernel E calls each, then the case's step, then three such sessions again;
it prints the ln_film_bwd_kernel events each session recorded. The cases'
steps: 'none' nothing; 'work' two nano training steps through the CLI
(synthetic data); 'cpu' an empty CPU-only profiler session; 'cpu-work' a
CPU-only session (with shapes, as chip_smoke.py's phase 18) around the same
two steps. Needs the card:

  python3 -m gencast_tpu_torch.tools.profiler_sessions
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

CASES = ('none', 'work', 'cpu', 'cpu-work')
CALLS = 14
SHAPE = (1, 10304, 512)  # a 1-degree mesh's [B, nodes, d_model]; axis 0


def e_sessions(calls) -> list:
  """Kernel E events recorded by each of three CUDA profiler sessions."""
  from gencast_tpu_torch.ops import ln_film
  counts = []
  for _ in range(3):
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) as prof:
      for x, dy, scale in calls:
        ln_film.ln_film_bwd_cuda(x, dy, scale, 0)
      torch.cuda.synchronize()
    counts.append(sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and 'ln_film_bwd_kernel' in e.name))
  return counts


def two_nano_steps() -> None:
  from gencast_tpu_torch.training import train
  train.main(['--preset', 'nano', '--data', 'synthetic', '--steps', '2',
              '--prefetch', '0', '--log_every', '1'])


def run_case(case: str) -> dict:
  dev = torch.device('cuda', 0)
  g = torch.Generator(device=dev).manual_seed(0)
  calls = [(torch.randn(SHAPE, generator=g, device=dev).bfloat16(),
            torch.randn(SHAPE, generator=g, device=dev).bfloat16(),
            (1 + 0.1 * torch.randn((1, SHAPE[2]), generator=g, device=dev)
             ).bfloat16()) for _ in range(CALLS)]
  before = e_sessions(calls)
  if case in ('cpu', 'cpu-work'):
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        record_shapes=True) as prof:
      if case == 'cpu-work':
        two_nano_steps()
    cpu_events = len(prof.events())
  else:
    cpu_events = None
    if case == 'work':
      two_nano_steps()
  return {'case': case, 'calls_per_session': CALLS, 'before': before,
          'cpu_only_session_events': cpu_events, 'after': e_sessions(calls)}


def main(argv) -> int:
  if argv[:1] == ['--case']:
    print('RESULT ' + json.dumps(run_case(argv[1])), flush=True)
    return 0
  repo = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  for case in CASES:
    done = subprocess.run(
        [sys.executable, '-m', 'gencast_tpu_torch.tools.profiler_sessions',
         '--case', case], cwd=repo, capture_output=True, text=True,
        timeout=600)
    if done.returncode:
      print(f'{case}: exit {done.returncode}\n{done.stderr[-3000:]}',
            flush=True)
      return done.returncode
    print(next(line for line in done.stdout.splitlines()
               if line.startswith('RESULT ')), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
