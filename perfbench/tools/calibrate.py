"""Readings that the limits of `correct` are set from, on the card.

    python3 perfbench/tools/calibrate.py --workload <cell> \
        --seeds 11 12 ... --control-seeds 11 12 13 [--fault-seeds 11 12 13] \
    [--out FILE]

In one process, for each seed: the cell's set-up and one request or the
checked steps (as a run of the cell makes them, at the cell's own sizes
and load), then the check against the float32 reference (the program's
reading), and for each control seed the same check against the reference
computed in float8 (`reference.model.Precision('fp8')`), standing in the
program's place; for each fault seed of a training cell, the check of a
run with each of `lib/faults.py`'s training faults planted. One JSON line
a reading: {"seed", "kind": "program", "control" or "fault:<name>",
"checks": {name: value}}; with --out, all of them in that file too. The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from perfbench.lib import harness  # noqa: E402


def readings(workload: str, seeds, control_seeds, device='cuda',
             bench=None, workloads_dir=None, fault_seeds=()):
  """Yields one reading a seed and kind."""
  import torch
  from perfbench.lib import faults
  from perfbench.reference import graph as graph_lib
  from perfbench.reference import model as ref
  bench = bench or harness.read_json(os.path.join(harness.ROOT,
                                                  'BENCHMARK.json'))
  entry, config, params = harness.cell_files(
      bench, workload, workloads_dir or os.path.join(harness.BENCH_DIR,
                                                     'workloads'))
  traffic = harness.load_module(
      os.path.join(harness.BENCH_DIR, 'traffic', f'{entry["traffic"]}.py'),
      f'perfbench_traffic_{entry["traffic"]}')
  graph = graph_lib.cached(config, harness.GRAPH_CACHE)
  runs = [(seed, None) for seed in seeds]
  if entry['traffic'] == 'train':
    runs += [(seed, f) for seed in fault_seeds for f in faults.TRAIN]
  for seed, fault in runs:
    t0 = time.perf_counter()
    cell = traffic.Cell(config, params, seed, device)
    if fault is not None:
      faults.plant(cell, fault)
    cell.setup()
    if cell.kind == 'forecast':
      cell.window(1e-9)     # one request
    cell.free()
    gc.collect()
    if torch.device(device).type == 'cuda':
      torch.cuda.empty_cache()
    kinds = ([(f'fault:{fault}', 'f32')] if fault is not None else
             [('program', 'f32')] + ([('control', 'fp8')]
                                     if seed in control_seeds else []))
    for kind, precision in kinds:
      with harness.full_float32():
        checks = cell.check(graph, ref.Precision(precision), every=True)
      yield {'seed': seed, 'kind': kind,
             'checks': {c.name: c.value for c in checks},
             'seconds': time.perf_counter() - t0}
    del cell
    gc.collect()


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', type=int, nargs='+', required=True)
  p.add_argument('--control-seeds', type=int, nargs='*', default=[])
  p.add_argument('--fault-seeds', type=int, nargs='*', default=[])
  p.add_argument('--out', default=None)
  args = p.parse_args(argv)
  harness.cache_environment()
  import torch
  if not torch.cuda.is_available():
    print('calibrate: no CUDA device', file=sys.stderr)
    return 2
  out = []
  for r in readings(args.workload, args.seeds, set(args.control_seeds),
                    fault_seeds=args.fault_seeds):
    print(json.dumps(r), flush=True)
    out.append(r)
  if args.out:
    with open(args.out, 'w') as f:
      json.dump(out, f, indent=1)
  return 0


if __name__ == '__main__':
  sys.exit(main())
