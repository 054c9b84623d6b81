"""Whole runs of the harness on the CPU at the TINY configuration
(`tests/data`): the result line's schema, the refusals, and the check
coming out false with the timed path broken underneath."""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest

from perfbench.lib import faults, harness

DATA = os.path.join(harness.BENCH_DIR, 'tests', 'data')
WORKLOADS = os.path.join(DATA, 'workloads')


def bench():
  return harness.read_json(os.path.join(DATA, 'BENCHMARK.json'))


def run(cell, seed=2 ** 31 + 7, seconds=0.5, plant=None):
  args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                            trace=0)
  return harness.run(args, bench(), 'cpu', time.perf_counter(),
                     workloads_dir=WORKLOADS, plant=plant)


@pytest.mark.parametrize('cell', ['tiny.forecast', 'tiny.train'])
def test_result_line(cell):
  out = run(cell)
  assert list(out)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                           'device']
  assert list(out)[-1] == 'checks'
  assert out['correct'] is True and out['failed'] == 0
  assert out['attempted'] >= 1
  names = set(out['metrics'])
  assert 'setup_s' in names and len(names) >= 2
  for m in out['metrics'].values():
    assert set(m) == {'value', 'unit'} and m['value'] > 0
  for c in out['checks'].values():
    assert c['value'] <= c['limit']
  json.dumps(out)


@pytest.mark.parametrize('fault', faults.FORECAST)
def test_forecast_fault_is_caught(fault):
  out = run('tiny.forecast', plant=lambda c: faults.plant(c, fault))
  assert out['correct'] is False, out['checks']


@pytest.mark.parametrize('fault', faults.TRAIN)
def test_train_fault_is_caught(fault):
  out = run('tiny.train', plant=lambda c: faults.plant(c, fault))
  assert out['correct'] is False, out['checks']


def test_same_seed_same_inputs():
  import torch
  from perfbench.lib import synthetic
  entry, config, _ = harness.cell_files(bench(), 'tiny.forecast', WORKLOADS)
  s = synthetic.stats(config, 2 ** 33 + 1)
  a = synthetic.Weather(config, s, 'cpu').window(99)
  b = synthetic.Weather(config, s, 'cpu').window(99)
  c = synthetic.Weather(config, s, 'cpu').window(100)
  for x, y, z in zip(a, b, c):
    assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
    assert not torch.equal(torch.nan_to_num(x), torch.nan_to_num(z))


def test_refuses_without_a_card(monkeypatch, capsys):
  import torch
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  code = harness.main(['--workload', 'gencast_1p0deg.forecast_m8',
                       '--seed', str(2 ** 31 + 3), '--seconds', '1',
                       '--trace', '0'], time.perf_counter())
  assert code != 0
  assert capsys.readouterr().out == ''


def test_refuses_jax(monkeypatch):
  monkeypatch.setitem(sys.modules, 'jax.numpy', object())
  assert harness.forbidden_modules() == ['jax.numpy']
  monkeypatch.delitem(sys.modules, 'jax.numpy')
  monkeypatch.setitem(sys.modules, 'gencast_tpu_torch_like', object())
  assert harness.forbidden_modules() == []


def test_refuses_in_a_bare_checkout(tmp_path):
  """A directory with only BENCHMARK.json and perfbench/ has no program:
  the run exits non-zero and prints no result."""
  import shutil
  shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
  shutil.copytree(harness.BENCH_DIR, tmp_path / 'perfbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  proc = subprocess.run(
      [sys.executable, 'perfbench/run.py', '--workload',
       'gencast_1p0deg.forecast_m8', '--seed', '5', '--seconds', '1',
       '--trace', '0'], cwd=tmp_path, capture_output=True, text=True,
      timeout=120, env=dict(os.environ, PYTHONPATH=''))
  assert proc.returncode != 0
  assert proc.stdout.strip() == ''


def test_idle_share_leaves_out_the_profilers_own_time():
  from perfbench.lib.trace import Trace
  t = Trace()
  t.window = (0.0, 100.0)
  t.kernels = [(0.0, 30.0, 'k'), (20.0, 40.0, 'k'), (60.0, 100.0, 'k')]
  # Idle 40-60; the profiler's buffer request covers 45-55, and 35-50 of
  # the program's own host work does not count.
  t.host = [(45.0, 55.0, 'Activity Buffer Request'),
            (35.0, 50.0, 'perfbench.step')]
  assert t.busy_s() == pytest.approx(80e-6)
  assert t.profiler_idle_s() == pytest.approx(10e-6)
  assert t.idle_share() == pytest.approx(100.0 * 10 / 90)
  assert [n for n, _ in t.idle_gaps()] == ['Activity Buffer Request']
