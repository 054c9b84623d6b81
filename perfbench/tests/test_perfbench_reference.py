"""The plain reference against the program's plain path, and the control.

At TINY on the CPU with the program in float32, the reference gives the
program's answers to float32 rounding: the sampled forecast of each
checked member and the first three training steps (losses, first
gradients, changes). With the program in bf16 as the configuration states,
the float8 control reads several times the program's gap. On a card
(`-m card`), the control at each cell's own size on three seeds fails the
cell's limits and the program passes them.
"""

import os

import pytest

from perfbench.lib import harness
from perfbench.reference import model as ref
from perfbench.tools import calibrate

DATA = os.path.join(harness.BENCH_DIR, 'tests', 'data')
WORKLOADS = os.path.join(DATA, 'workloads')


def readings(cell, seeds, control, bench=None, device='cpu'):
  return list(calibrate.readings(cell, seeds, set(control), device,
                                 bench, None if bench is None else WORKLOADS))


def tiny_bench():
  return harness.read_json(os.path.join(DATA, 'BENCHMARK.json'))


@pytest.fixture
def float32_program(monkeypatch):
  """The TINY configuration with the program in float32."""
  from perfbench.lib import program
  real = program.spec

  def spec(config):
    return real(dict(config, cast_bf16=False))
  monkeypatch.setattr(program, 'spec', spec)
  real_load = program.load

  def load(p, weights, stats, config):
    return real_load(p, weights, stats, dict(config, cast_bf16=False))
  monkeypatch.setattr(program, 'load', load)


@pytest.mark.parametrize('cell', ['tiny.forecast', 'tiny.train'])
def test_reference_is_the_program_in_float32(cell, float32_program):
  (r,) = readings(cell, [2 ** 31 + 11], [], tiny_bench())
  for name, value in r['checks'].items():
    assert value < 2e-5, (name, value)


def test_forecast_control_fails_where_the_program_passes():
  rs = readings('tiny.forecast', [2 ** 31 + 21, 2 ** 32 + 22],
                [2 ** 31 + 21, 2 ** 32 + 22], tiny_bench())
  prog = max(r['checks']['forecast_rel_l2'] for r in rs
             if r['kind'] == 'program')
  ctrl = min(r['checks']['forecast_rel_l2'] for r in rs
             if r['kind'] == 'control')
  assert ctrl >= 3 * prog, (ctrl, prog)


def test_train_control_fails_where_the_program_passes():
  rs = readings('tiny.train', [2 ** 31 + 31, 2 ** 32 + 32],
                [2 ** 31 + 31, 2 ** 32 + 32], tiny_bench())
  for name in ('grad_norm_gap', 'change_norm_gap'):
    prog = max(r['checks'][name] for r in rs if r['kind'] == 'program')
    ctrl = min(r['checks'][name] for r in rs if r['kind'] == 'control')
    assert ctrl >= 3 * prog, (name, ctrl, prog)


def test_precision_rounds_to_float8():
  import torch
  x = torch.linspace(-3, 3, 101)
  q = ref.Precision('fp8')(x)
  assert not torch.equal(q, x)
  assert float((q - x).abs().max()) <= 3 * 2 ** -4
  assert torch.equal(ref.Precision('f32')(x), x)


CELLS = [w['name'] for w in harness.read_json(
    os.path.join(harness.ROOT, 'BENCHMARK.json'))['workloads']]


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_the_cell_on_the_card(cell, card):
  """At the cell's own size, on three seeds: the program's readings pass
  every limit, the float8 control's fail one at least."""
  _, _, params = harness.cell_files(harness.read_json(os.path.join(
      harness.ROOT, 'BENCHMARK.json')), cell)
  limits = params['limits']
  seeds = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]
  harness.cache_environment()
  for r in readings(cell, seeds, seeds, device='cuda'):
    failed = [n for n, v in r['checks'].items()
              if n in limits and not v <= limits[n]]
    assert bool(failed) == (r['kind'] == 'control'), r
