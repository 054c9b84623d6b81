"""Where a cell's device time and idle time go, by the program's spans.

    python3 perfbench/tools/spans.py --workload <cell> --seed <n> \
        [--out FILE]

One traced run of the cell, as `run.py --trace 1` makes it (set-up, then
the cell's `traced_units` requests or steps under torch.profiler), without
the check. It prints, from `lib/spans.py`'s segmentation of the window:

1. device seconds by span (forward, gradient and recomputation regions,
   nested spans included), the seconds whose innermost span it is, and its
   marks by edge and pass;
2. device seconds outside every program span (other streams' copies
   included);
3. the mark kernels' own device seconds per unit;
4. idle seconds by the innermost program host span running in each gap,
   or outside the program, the profiler's own operations left out as
   `idle_share` leaves them out (the rows add up to its idle time);
5. device seconds of kernel families A, F-dq, F-dk/dv, B and E, and of
   AdamW's `multi_tensor_apply` kernels, by layer: the attribution check
   (A and F in `processor`, B in the GNNs, AdamW in `optimizer`);

then the span metrics the cell reports. With --out, the same as one JSON
object. The Chrome trace of the training CLI's `--profile_dir` shows the
same marks (kernels `gt_span_<span>_<edge>`) and host spans
(`gencast.<span>`) in Perfetto. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from perfbench.lib import harness, spans  # noqa: E402

CHECKED = ('A', 'F-dq', 'F-dk/dv', 'B', 'E', 'AdamW')
# Where the attribution check wants each family, and the least share.
WANTED = {'A': ({'processor'}, 99.0), 'F-dq': ({'processor'}, 99.0),
          'F-dk/dv': ({'processor'}, 99.0),
          'B': ({'grid2mesh', 'mesh2grid'}, 99.0),
          'AdamW': ({'optimizer'}, 100.0)}
OUTSIDE_LIMIT = 3.0   # % of the window's device seconds


def family(name: str) -> str:
  """`spans.family`, with AdamW's foreach kernels on their own."""
  return 'AdamW' if 'multi_tensor_apply' in name else spans.family(name)


def traced(workload: str, seed: int, bench: dict, device='cuda'):
  """(cell, trace) of one traced run of `workload`."""
  from perfbench.lib.trace import Trace
  entry, config, params = harness.cell_files(bench, workload)
  traffic = harness.load_module(
      os.path.join(harness.BENCH_DIR, 'traffic', f'{entry["traffic"]}.py'),
      f'perfbench_traffic_{entry["traffic"]}')
  cell = traffic.Cell(config, params, seed, device)
  cell.setup()
  trace = Trace()
  trace.units = int(params['traced_units'])
  with trace.record():
    for _ in range(trace.units):
      cell.unit()
    if hasattr(cell, 'drain'):
      cell.drain()
  return cell, trace


def report(trace, cell, bench: dict, workload: str) -> dict:
  """The five tables and the span metrics of a traced window."""
  from perfbench.lib import readers
  seg = spans.segmented(trace)
  by_span = {}
  for name, _, device, _, _ in spans.SPANS:
    if not device:
      continue
    by_span[name] = {
        'device_s': seg.inclusive_s(name),
        'share': seg.share(seg.inclusive_s(name)),
        'innermost_s': seg.innermost_s(name),
        'marks': {f'{edge}.{p}': n for (s, edge, p), n in
                  sorted(seg.marks.items()) if s == name}}
  layers = seg.by_layer(family)
  fams = {}
  for fam in CHECKED:
    total = sum(sec for (f, _), sec in layers.items() if f == fam)
    where = {layer: sec for (f, layer), sec in layers.items() if f == fam}
    fams[fam] = {'device_s': total, 'by_layer': where}
  checks = {}
  for fam, (want, least) in WANTED.items():
    total = fams[fam]['device_s']
    if total > 0:
      inside = sum(fams[fam]['by_layer'].get(layer, 0.0) for layer in want)
      checks[fam] = {'share_in': 100.0 * inside / total, 'least': least,
                     'ok': 100.0 * inside / total >= least - 1e-9}
  outside = seg.share(seg.outside_s())
  checks['outside'] = {'share': outside, 'most': OUTSIDE_LIMIT,
                       'ok': outside is not None
                       and outside <= OUTSIDE_LIMIT}
  idle = spans.idle_by_host_span(trace)
  stolen = trace.profiler_idle_s()
  ctx = readers.Context(cell=cell, trace=trace, peak_bytes=0)
  metrics = {}
  for m in bench['per_layer']:
    if m['source'] == 'program_span' and harness.applies(m, workload):
      reader = harness.load_module(
          os.path.join(harness.BENCH_DIR, 'metrics', f'{m["name"]}.py'),
          f'perfbench_metric_{m["name"]}')
      metrics[m['name']] = reader.read(ctx)
  return {
      'units': trace.units, 'window_s': trace.window_s,
      'device_s': seg.total_s, 'busy_s': trace.busy_s(),
      'by_span': by_span,
      'outside_s': seg.outside_s(), 'other_stream_s': seg.other_stream_s,
      'outside_share': outside,
      'mark_s_per_unit': seg.mark_s / max(trace.units, 1),
      'marks_per_unit': sum(seg.marks.values()) / max(trace.units, 1),
      'idle_s': idle, 'idle_total_s': sum(idle.values()),
      'idle_window_s': trace.window_s - stolen - trace.busy_s(),
      'idle_share': trace.idle_share(),
      'families': fams, 'checks': checks, 'metrics': metrics,
      'optimizer_families': {f: sec for (f, layer), sec in layers.items()
                             if layer == 'optimizer'},
  }


def show(r: dict) -> None:
  def line(msg):
    print(f'[spans] {msg}', flush=True)

  line(f'{r["units"]} traced units, window {r["window_s"]:.4f} s, device '
       f'{r["device_s"]:.4f} s (busy {r["busy_s"]:.4f} s)')
  for name, s in r['by_span'].items():
    share = '-' if s['share'] is None else f'{s["share"]:.3f}%'
    line(f'span {name}: {s["device_s"]:.6f} s ({share}), innermost '
         f'{s["innermost_s"]:.6f} s, marks {s["marks"]}')
  line(f'outside every program span: {r["outside_s"]:.6f} s '
       f'({r["outside_share"]}%), of it other streams\' copies '
       f'{r["other_stream_s"]:.6f} s')
  line(f'span marks: {r["marks_per_unit"]:.1f} a unit, '
       f'{1e3 * r["mark_s_per_unit"]:.4f} ms of device time a unit')
  idle = ', '.join(f'{k} {v:.6f}' for k, v in
                   sorted(r['idle_s'].items(), key=lambda kv: -kv[1]))
  line(f'idle s by program host span: {idle}; sum {r["idle_total_s"]:.6f} '
       f'of {r["idle_window_s"]:.6f} (idle_share {r["idle_share"]:.4f}%)')
  for fam, f in r['families'].items():
    where = ', '.join(f'{k} {v:.6f}' for k, v in
                      sorted(f['by_layer'].items(), key=lambda kv: -kv[1]))
    line(f'family {fam}: {f["device_s"]:.6f} s: {where}')
  opt = ', '.join(f'{k} {v:.6f}' for k, v in
                  sorted(r['optimizer_families'].items(),
                         key=lambda kv: -kv[1]))
  line(f'optimizer span by family: {opt}')
  line(f'checks: {json.dumps(r["checks"])}')
  line(f'metrics: {json.dumps(r["metrics"])}')


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--out', default=None)
  args = p.parse_args(argv)
  harness.cache_environment()
  import torch
  if not torch.cuda.is_available():
    print('spans: no CUDA device', file=sys.stderr)
    return 2
  bench = harness.read_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
  t0 = time.perf_counter()
  cell, trace = traced(args.workload, args.seed, bench)
  print(f'[spans] {args.workload} seed {args.seed}: {harness.card_line()}; '
        f'set-up and traced units {time.perf_counter() - t0:.1f} s',
        flush=True)
  r = report(trace, cell, bench, args.workload)
  show(r)
  cell.free()
  if args.out:
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
      json.dump(dict(r, workload=args.workload, seed=args.seed), f,
                indent=1)
  return 0


if __name__ == '__main__':
  sys.exit(main())
