"""BENCHMARK.json against the benchmark's contract, and the harness finding
each cell, configuration, traffic kind and metric by name."""

import json
import math
import os
import re

import pytest

from perfbench.lib import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
TOP = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
       'end_to_end', 'per_layer'}


def line(text):
  return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_keys_and_size():
  assert set(BENCH) == TOP
  assert len(json.dumps(BENCH)) <= 64 * 1024
  assert BENCH['command'] == ['python3', 'perfbench/run.py']
  assert BENCH['paths'] == ['perfbench']
  assert 1 <= BENCH['run_seconds'] <= 51


def test_check_time_fits_with_24_cells():
  runs = 2 + 14 * 24
  assert runs * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
  names = [c['name'] for c in BENCH['configs']]
  assert len(set(names)) == len(names)
  used = {w['config'] for w in BENCH['workloads']}
  files = set()
  for c in BENCH['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(c['name']) and line(c['source']) and line(c['why'])
    assert c['name'] in used
    assert c['file'].startswith('perfbench/') and c['file'] not in files
    files.add(c['file'])
    config = json.load(open(os.path.join(ROOT, c['file'])))
    assert config['name'] == c['name'] and config['source'] == c['source']
    assert config['reduced'] == c['reduced']


def test_workloads():
  names = [w['name'] for w in BENCH['workloads']]
  assert len(set(names)) == len(names) and 1 <= len(names) <= 24
  pairs = {(w['config'], w['traffic']) for w in BENCH['workloads']}
  assert len(pairs) == len(names)
  assert sum(w['chips'] == 4 for w in BENCH['workloads']) <= max(
      1, len(names) // 4)
  for w in BENCH['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(w['name']) and NAME.match(w['traffic'])
    assert w['chips'] in (1, 4) and line(w['why'])


def metrics():
  return BENCH['end_to_end'] + BENCH['per_layer']


def test_metrics():
  names = [m['name'] for m in metrics()]
  assert len(set(names)) == len(names)
  e2e = {m['name'] for m in BENCH['end_to_end']}
  assert 'setup_s' in e2e
  for m in BENCH['end_to_end']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                      'source'}
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25
  setup = next(m for m in BENCH['end_to_end'] if m['name'] == 'setup_s')
  assert setup['bound'] == 0.25
  layers = {}
  for m in BENCH['per_layer']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                      'layer', 'moves'}
    assert m['moves'] in e2e and m['moves'] != 'setup_s'
    assert line(m['layer'])
    layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
  assert all(len(v) == 1 for v in layers.values())
  for m in metrics():
    assert NAME.match(m['name']) and UNIT.match(m['unit'])
    assert m['better'] in ('lower', 'higher')
    assert m['source'] in ('device_trace', 'program_span',
                           'program_counter', 'host_clock')


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_cell_reports_enough(cell):
  e2e = [m for m in BENCH['end_to_end'] if harness.applies(m, cell)]
  assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2
  layer = [m for m in BENCH['per_layer'] if harness.applies(m, cell)]
  assert layer
  for m in layer:
    assert m['moves'] in {x['name'] for x in e2e}


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_harness_finds_the_cell(cell):
  entry, config, params = harness.cell_files(BENCH, cell)
  assert entry['name'] == cell and config['name'] == entry['config']
  traffic = harness.load_module(os.path.join(
      harness.BENCH_DIR, 'traffic', f'{entry["traffic"]}.py'), 'traffic')
  assert traffic.Cell.kind == entry['traffic']
  assert params['limits'] and all(
      math.isfinite(v) and v > 0 for v in params['limits'].values())
  assert int(params['traced_units']) >= 1


@pytest.mark.parametrize('metric', [m['name'] for m in BENCH['per_layer']])
def test_harness_finds_the_metric(metric):
  reader = harness.load_module(os.path.join(
      harness.BENCH_DIR, 'metrics', f'{metric}.py'), 'reader')
  assert callable(reader.read)


def test_files_are_named_from_names():
  for dirpath, _, files in os.walk(harness.BENCH_DIR):
    for f in files:
      rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
      assert re.match(r'^[A-Za-z0-9_.\-/]+$', rel), rel
