"""The training CLI's input pipeline, with and without --prefetch and
--data_workers, from ERA5-format directories and synthetic data.

Writes two ERA5-format corpora in the npz layout (`tools.synth_era5
--layout npz`: 2.5 degrees, 2 months x 10 frames; 1 degree, 6 frames)
under --out, then runs `python3 -m gencast_tpu_torch.training.train` once
per (group, setting), each in a fresh process, in the order given and then
reversed, so a drift of the host shows as a difference between a setting's
two runs. Prints one JSON line per run: the preset, the data, --prefetch,
--data_workers, the CLI's `[train] pipeline` summary (batch wait and step
seconds: the first step's, the mean and largest over the later ones), the
process's wall seconds and the CPU seconds of the process and its worker
processes. Needs the card:

  python3 -m gencast_tpu_torch.tools.pipeline_ab --out build/pipeline_ab
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import time

# (name, preset, data, steps, [(--prefetch, --data_workers), ...])
GROUPS = (
    ('nano_era5', 'nano', 'nano', 16, [(0, 0), (2, 0), (0, 2), (2, 2)]),
    ('1deg', '1deg', None, 8, [(0, 0), (2, 0)]),
)
CORPORA = {'nano': (2.5, ('202001', '202002'), 10),
           '1deg': (1.0, ('202001',), 6)}


def run_cli(argv) -> dict:
  """The train CLI in a fresh process: its pipeline summary, the wall and
  the CPU seconds of the process and its children."""
  repo = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  before = resource.getrusage(resource.RUSAGE_CHILDREN)
  t0 = time.perf_counter()
  done = subprocess.run(
      [sys.executable, '-m', 'gencast_tpu_torch.training.train'] + argv,
      cwd=repo, capture_output=True, text=True, timeout=900)
  wall = time.perf_counter() - t0
  after = resource.getrusage(resource.RUSAGE_CHILDREN)
  if done.returncode:
    raise RuntimeError(f'{argv}: exit {done.returncode}\n'
                       f'{done.stdout[-2000:]}\n{done.stderr[-4000:]}')
  prefix = '[train] pipeline '
  summary = json.loads(next(line for line in done.stdout.splitlines()
                            if line.startswith(prefix))[len(prefix):])
  cpu = (after.ru_utime + after.ru_stime) - (before.ru_utime
                                             + before.ru_stime)
  return {'batch_wait_s': summary['batch_wait_s'],
          'step_s': summary['step_s'], 'wall_s': wall, 'cpu_s': cpu}


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--out', required=True,
                 help='directory for the corpora (emptied, then removed)')
  args = p.parse_args(argv)
  from gencast_tpu_torch.tools import synth_era5
  shutil.rmtree(args.out, ignore_errors=True)
  dirs = {}
  for name, (res, months, steps) in CORPORA.items():
    dirs[name] = os.path.join(args.out, name)
    synth_era5.synthesize(dirs[name], resolution_deg=res, months=months,
                          steps_per_month=steps, seed=0, layout='npz')
  runs = []
  for group, preset, corpus, steps, settings in GROUPS:
    datas = [dirs[corpus]] if corpus else [dirs['1deg'], 'synthetic']
    order = [(d, s) for s in settings for d in datas]
    runs += [(group, preset, d, steps, s) for d, s in order + order[::-1]]
  for group, preset, data, steps, (prefetch, workers) in runs:
    extra = ['--clean_sst_nans'] if preset == '1deg' else []
    result = run_cli(
        ['--preset', preset, '--data', data, '--steps', str(steps),
         '--prefetch', str(prefetch), '--data_workers', str(workers)]
        + extra)
    print(json.dumps({'group': group, 'preset': preset,
                      'data': 'synthetic' if data == 'synthetic' else 'era5',
                      'prefetch': prefetch, 'data_workers': workers,
                      'steps': steps, **result}), flush=True)
  shutil.rmtree(args.out, ignore_errors=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
