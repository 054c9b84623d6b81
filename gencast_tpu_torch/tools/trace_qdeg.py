"""Profile one 0.25-degree training step and print the device-time breakdown.

Counterpart of `tools/trace_qdeg.py`. On one CUDA card:

    python -m gencast_tpu_torch.tools.trace_qdeg [outdir] [preset]

`run` is `training/profile_step.py --mode train --steps 1 --trace
outdir/profile.pt.trace.json` at the preset (0.25deg by default: kernels
A, B, E and F): the training CLI's model and wrapper stack, one warm-up
step, one unprofiled step and one step under the process's first profiler
session, with the step's wall, model FLOPs and MFU (against the H100 SXM's
dense bf16 peak) beside the card's name and power limit. `parse` reads the
trace back: device time by kernel family (profile_step's families) and by
kernel.
"""

from __future__ import annotations

import os
import sys

from gencast_tpu_torch import utils
from gencast_tpu_torch.training import profile_step


def run(outdir: str, spec_name: str = '0.25deg', mode: str = 'train') -> None:
  """One profiled `profile_step` step of preset `spec_name` in `mode` on
  the card, its Chrome trace written to `outdir`/utils.TRACE_FILE."""
  profile_step.main(['--preset', spec_name, '--mode', mode, '--steps', '1',
                     '--trace', os.path.join(outdir, utils.TRACE_FILE)])


def parse(outdir: str, top: int = 45) -> dict:
  """Device time of the trace in `outdir` by kernel family and by kernel
  name (`profile_step.breakdown` of its kernels and copies); prints the
  breakdown and returns it."""
  path = os.path.join(outdir, utils.TRACE_FILE)
  if not os.path.exists(path):
    raise SystemExit(f'no trace at {path}')
  kernels = profile_step.trace_kernels(path)
  if not kernels:
    raise SystemExit(f'{path}: the trace holds no device kernel')
  b = profile_step.breakdown(kernels)
  print(f'[profile] {path}: {b["total_ms"]:.2f} ms of device time over '
        f'{len(b["kernels"])} distinct kernels and copies')
  profile_step.print_breakdown(b, 'in the trace', top=top)
  return b


def main(argv=None) -> None:
  argv = sys.argv[1:] if argv is None else argv
  out = argv[0] if argv else os.path.join('build', 'trace_qdeg')
  run(out, argv[1] if len(argv) > 1 else '0.25deg')
  parse(out)


if __name__ == '__main__':
  main()
