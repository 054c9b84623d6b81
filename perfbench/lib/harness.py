"""The benchmark's runner: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name: its entry in BENCHMARK.json names a
configuration (the file the entry gives) and a traffic kind; its
parameters are `perfbench/workloads/<cell>.json`, its traffic
`perfbench/traffic/<kind>.py`, each per-layer metric
`perfbench/metrics/<metric>.py`. A run sets up (building the program,
loading weights, warming up every shape the cell uses), measures for the
given seconds (with --trace 1, profiles the cell's traced requests or
steps instead), reads the peak memory, frees the program, checks what the
timed path produced against the plain reference, and prints its result as
the last line of standard output, the compared numbers beside their limits
last on standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, 'perfbench')
# Every cache the program or the benchmark writes lies in the checkout, at
# fixed paths, so only a checkout's first run builds.
BUILD = os.path.join(ROOT, 'build')
GRAPH_CACHE = os.path.join(BUILD, 'perfbench')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'gencast_tpu')


def cache_environment() -> None:
  os.environ['GENCAST_TPU_TORCH_CACHE'] = BUILD
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(BUILD,
                                                    'torch_extensions')
  os.environ['TRITON_CACHE_DIR'] = os.path.join(BUILD, 'triton')


def forbidden_modules() -> List[str]:
  """Loaded modules whose top-level name is one the port must not load."""
  return sorted({m for m in list(sys.modules)
                 if m.split('.')[0] in FORBIDDEN})


def load_module(path: str, name: str):
  spec = importlib.util.spec_from_file_location(name, path)
  if spec is None:
    raise FileNotFoundError(path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def read_json(path: str) -> dict:
  with open(path) as f:
    return json.load(f)


def cell_files(bench: dict, name: str,
               workloads_dir: str = os.path.join(BENCH_DIR, 'workloads')):
  """(entry, configuration, parameters) of cell `name`."""
  entry = next((w for w in bench['workloads'] if w['name'] == name), None)
  if entry is None:
    raise KeyError(f'no cell {name!r} in BENCHMARK.json')
  conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
  config = read_json(os.path.join(ROOT, conf['file']))
  params = read_json(os.path.join(workloads_dir, f'{name}.json'))
  return entry, config, params


def applies(metric: dict, cell: str) -> bool:
  return 'workloads' not in metric or cell in metric['workloads']


def parse(argv) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def run(args, bench: dict, device, started: float,
        workloads_dir: str = os.path.join(BENCH_DIR, 'workloads'),
        plant=None) -> Optional[dict]:
  """One run; the result line's object, or None where the run must not
  print one. `plant(cell)` may replace part of the timed path (tests)."""
  import torch
  from perfbench.lib import readers
  from perfbench.lib.trace import Trace
  from perfbench.reference import graph as graph_lib

  entry, config, params = cell_files(bench, args.workload, workloads_dir)
  traffic = load_module(os.path.join(BENCH_DIR, 'traffic',
                                     f'{entry["traffic"]}.py'),
                        f'perfbench_traffic_{entry["traffic"]}')
  cell = traffic.Cell(config, params, args.seed, device)
  if plant is not None:
    plant(cell)
  card = torch.device(device).type == 'cuda'
  if card:
    torch.cuda.reset_peak_memory_stats()
  imports_s = time.perf_counter() - started
  cell.setup()
  setup_s = time.perf_counter() - started
  log(f'[perfbench] {args.workload}: set-up {setup_s:.3f} s (start and '
      f'imports {imports_s:.3f}, {getattr(cell, "phases", "")})')

  trace = None
  measured = {}
  if args.trace:
    trace = Trace()
    trace.units = int(params['traced_units'])
    with trace.record():
      for _ in range(trace.units):
        cell.unit()
      if hasattr(cell, 'drain'):
        cell.drain()
  else:
    measured = cell.window(args.seconds)
  found = forbidden_modules()
  if found:
    log(f'[perfbench] the run loaded {", ".join(found)}: no result')
    return None
  peak = torch.cuda.max_memory_allocated() if card else 0

  graph = graph_lib.cached(config, GRAPH_CACHE)
  ctx = readers.Context(cell=cell, trace=trace, peak_bytes=peak,
                        graph=graph)
  metrics = {}
  if args.trace:
    fam = sorted(trace.family_seconds().items(), key=lambda kv: -kv[1])
    log('[perfbench] device seconds by kernel family over '
        f'{trace.units} traced units: '
        + ', '.join(f'{k} {v:.4f}' for k, v in fam))
    log(f'[perfbench] traced window {trace.window_s:.4f} s, device busy '
        f'{trace.busy_s():.4f} s, idle in the profiler\'s own operations '
        f'{trace.profiler_idle_s():.4f} s')
    for m in bench['per_layer']:
      if not applies(m, args.workload):
        continue
      reader = load_module(os.path.join(BENCH_DIR, 'metrics',
                                        f'{m["name"]}.py'),
                           f'perfbench_metric_{m["name"]}')
      value = reader.read(ctx)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
  else:
    measured['setup_s'] = setup_s
    for m in bench['end_to_end']:
      if applies(m, args.workload) and m['name'] in measured:
        metrics[m['name']] = {'value': measured[m['name']],
                              'unit': m['unit']}

  cell.free()
  gc.collect()
  if card:
    torch.cuda.empty_cache()
  t0 = time.perf_counter()
  with full_float32():
    checks = cell.check(graph)
  log(f'[perfbench] check against the plain reference: '
      f'{time.perf_counter() - t0:.3f} s')
  found = forbidden_modules()
  if found:
    log(f'[perfbench] the run loaded {", ".join(found)}: no result')
    return None

  result = {'correct': all(c.ok for c in checks),
            'attempted': cell.attempted,
            'failed': sum(not c.ok for c in checks),
            'metrics': metrics,
            'device': device_record(torch, device, entry['chips'], peak)}
  if trace is not None:
    result['device'].update(busy_s=trace.busy_s(), window_s=trace.window_s)
    result['breakdown'] = trace.breakdown()
  result['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                      for c in checks}
  for c in checks:
    log(f'check {c.name} {c.value!r} limit {c.limit!r}')
  return result


class full_float32:
  """Float32 products in full float32 (TF32 off) while the reference
  runs; the settings are put back after."""

  def __enter__(self):
    import torch
    self.saved = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

  def __exit__(self, *exc):
    import torch
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = self.saved


def device_record(torch, device, chips: int, peak: int) -> dict:
  if torch.device(device).type != 'cuda':
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': 0}
  return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
          'count': chips, 'memory_peak_bytes': peak}


def card_line() -> str:
  import subprocess
  try:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
  except (OSError, subprocess.SubprocessError, IndexError):
    return 'nvidia-smi not readable'


def main(argv, started: float) -> int:
  args = parse(argv)
  cache_environment()
  bench = read_json(os.path.join(ROOT, 'BENCHMARK.json'))
  entry = next((w for w in bench['workloads']
                if w['name'] == args.workload), None)
  if entry is None:
    log(f'[perfbench] no cell {args.workload!r}')
    return 2
  import torch
  if not torch.cuda.is_available() or \
      torch.cuda.device_count() < entry['chips']:
    log(f'[perfbench] {args.workload} needs {entry["chips"]} CUDA '
        f'device(s); this machine has '
        f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
    return 2
  torch.set_num_threads(4)
  log(f'[perfbench] card: {card_line()}')
  result = run(args, bench, 'cuda', started)
  if result is None:
    return 3
  print(json.dumps(result), flush=True)
  return 0
