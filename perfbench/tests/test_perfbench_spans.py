"""`lib/spans.py` on hand-built traces: nested spans, gradient regions,
recomputation without an end mark, copies of another stream, shares that
add up, the readers of the span metrics, the idle time by host span, and
its frozen span table against the program's."""

import os
import types

import pytest

from perfbench.lib import harness, spans
from perfbench.lib.trace import Trace


def _trace(ops, host=(), gap=1.0):
  """A window of `ops` ((name, microseconds) or (name, start, end)) laid
  one after another, `gap` apart, unless they give their own times."""
  t = Trace()
  now = 0.0
  for op in ops:
    if len(op) == 3:
      name, start, end = op
      t.kernels.append((start, end, name))
    else:
      name, dur = op
      t.kernels.append((now, now + dur, name))
      now += dur + gap
  t.kernels.sort()
  t.host = list(host)
  t.window = (0.0, max([e for _, e, _ in t.kernels] + [now]))
  t.units = 1
  return t


def m(span, edge):
  return f'gt_span_{span}_{edge}'


def _ctx(trace, kind='train'):
  from perfbench.lib import readers
  return readers.Context(cell=types.SimpleNamespace(kind=kind), trace=trace,
                         peak_bytes=0)


FORWARD = [
    (m('denoiser', 'begin'), 1), ('elementwise_kernel cast', 10),
    (m('grid2mesh', 'begin'), 1), ('segment_sum_kernel', 20),
    (m('grid2mesh', 'end'), 1),
    (m('processor', 'begin'), 1), ('sparse_attention_fwd_mma_kernel', 40),
    (m('remat', 'begin'), 1), ('nvjet gemm', 30), (m('remat', 'end'), 1),
    (m('processor', 'end'), 1),
    (m('mesh2grid', 'begin'), 1), ('segment_sum_kernel', 25),
    (m('mesh2grid', 'end'), 1),
    ('elementwise_kernel precond', 5), (m('denoiser', 'end'), 1),
]


def test_nested_spans_and_self_time():
  seg = spans.Segmented(_trace(FORWARD).kernels)
  assert seg.inclusive_s('denoiser') == pytest.approx(140e-6)
  assert seg.inclusive_s('processor') == pytest.approx(74e-6)
  assert seg.inclusive_s('remat') == pytest.approx(32e-6)
  assert seg.self_s('denoiser') == pytest.approx(17e-6)
  assert seg.innermost_s('processor') == pytest.approx(42e-6)
  layers = seg.by_layer()
  assert layers[('A', 'processor')] == pytest.approx(40e-6)
  assert layers[('B', 'grid2mesh')] == pytest.approx(20e-6)
  assert layers[('B', 'mesh2grid')] == pytest.approx(25e-6)
  assert layers[('cuBLAS matmuls', 'processor')] == pytest.approx(30e-6)


def test_gradient_regions_end_at_the_next_gradient_mark_or_the_backward():
  ops = FORWARD + [
      ('elementwise_kernel loss', 7),
      (m('backward', 'begin'), 1), ('reduce_kernel loss grad', 3),
      (m('denoiser', 'grad'), 1), ('elementwise_kernel precond grad', 4),
      (m('mesh2grid', 'grad'), 1), ('segment_sum_kernel', 11),
      (m('processor', 'grad'), 1), ('sparse_attention_dq_mma_kernel', 50),
      ('sparse_attention_dkv_mma_kernel', 60),
      (m('grid2mesh', 'grad'), 1), ('ln_film_bwd_kernel', 9),
      ('elementwise_kernel noise encoder grad', 2),
      (m('backward', 'end'), 1),
      (m('optimizer', 'begin'), 1), ('multi_tensor_apply_kernel adamw', 12),
      (m('optimizer', 'end'), 1),
  ]
  seg = spans.Segmented(_trace(ops).kernels)
  # grid2mesh's gradient runs to the backward's end (nothing closes it from
  # the input side), inside the denoiser's gradient region.
  assert seg.inclusive_s('grid2mesh') == pytest.approx(22e-6 + 12e-6)
  assert seg.inclusive_s('processor') == pytest.approx(74e-6 + 111e-6)
  assert seg.inclusive_s('mesh2grid') == pytest.approx(27e-6 + 12e-6)
  assert seg.self_s('denoiser') == pytest.approx(17e-6 + 5e-6)
  assert seg.inclusive_s('backward') == pytest.approx(145e-6)
  assert seg.inclusive_s('optimizer') == pytest.approx(14e-6)
  layers = seg.by_layer()
  assert layers[('F-dq', 'processor')] == pytest.approx(50e-6)
  assert layers[('F-dk/dv', 'processor')] == pytest.approx(60e-6)
  assert layers[('E', 'grid2mesh')] == pytest.approx(9e-6)
  assert layers[('reductions', 'backward')] == pytest.approx(3e-6)
  assert layers[('other', 'optimizer')] == pytest.approx(12e-6)
  assert seg.marks[('denoiser', 'grad', 'backward')] == 1


def test_a_recomputed_remat_without_its_end_mark():
  """In the backward pass a checkpoint recomputes and stops early: its
  begin mark has no end. The layer's gradient region goes on; only the
  forward pass's remat regions count as `remat`."""
  ops = FORWARD + [
      (m('backward', 'begin'), 1), (m('denoiser', 'grad'), 1),
      (m('mesh2grid', 'grad'), 1), (m('processor', 'grad'), 1),
      (m('remat', 'begin'), 1), ('nvjet gemm recomputed', 30),
      ('elementwise_kernel ffw grad', 8),
      (m('remat', 'begin'), 1), ('nvjet gemm recomputed', 30),
      (m('remat', 'end'), 1),
      (m('grid2mesh', 'grad'), 1), ('segment_sum_kernel', 6),
      (m('backward', 'end'), 1),
  ]
  seg = spans.Segmented(_trace(ops).kernels)
  assert seg.inclusive_s('remat') == pytest.approx(32e-6)
  assert seg.inclusive_s('processor') == pytest.approx(74e-6 + 72e-6)
  assert seg.inclusive_s('grid2mesh') == pytest.approx(22e-6 + 7e-6)
  assert seg.marks[('remat', 'begin', 'backward')] == 2
  assert seg.marks[('remat', 'end', 'backward')] == 1
  assert seg.marks[('remat', 'begin', 'forward')] == 1


def test_a_copy_on_another_stream_goes_to_no_layer():
  ops = [(m('denoiser', 'begin'), 0.0, 1.0),
         ('elementwise_kernel a', 2.0, 50.0),
         ('Memcpy DtoH (Device -> Pinned)', 10.0, 70.0),
         ('elementwise_kernel b', 51.0, 60.0),
         ('Memcpy DtoD (Device -> Device)', 61.0, 62.0),
         (m('denoiser', 'end'), 63.0, 64.0)]
  seg = spans.Segmented(_trace(ops).kernels)
  assert seg.other_stream_s == pytest.approx(60e-6)
  # The copy between two kernels of the stream is the stream's own.
  assert seg.inclusive_s('denoiser') == pytest.approx(
      (1 + 48 + 9 + 1 + 1) * 1e-6)
  assert seg.outside_s() == pytest.approx(60e-6)


def test_shares_add_up_with_outside():
  ops = [('elementwise_kernel before', 5)] + FORWARD + [
      (m('noise', 'begin'), 1), ('elementwise_kernel sph', 9),
      (m('noise', 'end'), 1), ('Memcpy HtoD', 3)]
  seg = spans.Segmented(_trace(ops).kernels)
  top = (seg.inclusive_s('denoiser') + seg.inclusive_s('noise')
         + seg.outside_s())
  assert seg.share(top) == pytest.approx(100.0)
  parts = (seg.self_s('denoiser')
           + sum(seg.inclusive_s(c) for c in spans.CHILDREN['denoiser']))
  assert parts == pytest.approx(seg.inclusive_s('denoiser'))
  assert sum(seg.seconds.values()) + seg.other_stream_s == pytest.approx(
      seg.total_s)


def _reader(name):
  return harness.load_module(os.path.join(
      harness.BENCH_DIR, 'metrics', f'{name}.py'), 'reader')


NEW = ('grid2mesh_share', 'processor_share', 'mesh2grid_share',
       'denoiser_self_share', 'noise_share')


@pytest.mark.parametrize('kind', ['forecast', 'train'])
def test_the_readers_on_a_program_with_and_without_spans(kind):
  marked = _trace([('elementwise_kernel before', 4)] + FORWARD + [
      (m('noise', 'begin'), 1), ('elementwise_kernel sph', 9),
      (m('noise', 'end'), 1)])
  seg = spans.segmented(marked)
  want = {'grid2mesh_share': seg.inclusive_s('grid2mesh'),
          'processor_share': seg.inclusive_s('processor'),
          'mesh2grid_share': seg.inclusive_s('mesh2grid'),
          'denoiser_self_share': seg.self_s('denoiser'),
          'noise_share': seg.inclusive_s('noise')}
  plain = _trace([('elementwise_kernel', 10), ('nvjet', 5)])
  other = 'train' if kind == 'forecast' else 'forecast'
  for name in NEW:
    read = _reader(f'{name}.{kind}').read
    assert read(_ctx(marked, kind)) == pytest.approx(
        100 * want[name] / seg.total_s)
    assert read(_ctx(plain, kind)) is None        # the parent: no marks
    assert read(_ctx(marked, other)) is None      # the other kind of cell
    assert read(_ctx(None, kind)) is None         # an untraced run


def test_the_training_readers():
  host = [(0.0, 3.0, 'gencast.train.stage step=3'),
          (5.0, 6.0, 'gencast.train.stage step=4'),
          (8.0, 12.0, 'gencast.train.stage step=5'),
          (1.0, 2.0, 'gencast.train.stage.other'),
          (0.0, 1.0, 'aten::add')]
  trace = _trace(FORWARD + [
      (m('optimizer', 'begin'), 1), ('multi_tensor_apply_kernel', 20),
      (m('optimizer', 'end'), 1)], host=host)
  seg = spans.segmented(trace)
  ctx = _ctx(trace)
  assert _reader('stage_ms.train').read(ctx) == pytest.approx(3e-3)
  assert _reader('remat_share.train').read(ctx) == pytest.approx(
      100 * 32e-6 / seg.total_s)
  assert _reader('optimizer_share.train').read(ctx) == pytest.approx(
      100 * 22e-6 / seg.total_s)
  plain = _ctx(_trace([('elementwise_kernel', 10)], host=[
      (0.0, 1.0, 'perfbench.step')]))
  for name in ('stage_ms', 'remat_share', 'optimizer_share'):
    assert _reader(f'{name}.train').read(plain) is None
    assert _reader(f'{name}.train').read(_ctx(trace, 'forecast')) is None


def test_idle_by_host_span_adds_up_to_the_idle_time():
  trace = _trace([('k1', 0.0, 10.0), ('k2', 20.0, 30.0), ('k3', 60.0, 70.0),
                  ('k4', 90.0, 100.0)], host=[
      (0.0, 40.0, 'gencast.train.stage step=1'),
      (12.0, 16.0, 'gencast.noise'),
      (35.0, 80.0, 'gencast.train.replay step=1'),
      (44.0, 48.0, 'Activity Buffer Request'),
      (0.0, 100.0, 'perfbench.step')])
  idle = spans.idle_by_host_span(trace)
  assert idle['noise'] == pytest.approx(4e-6)
  assert idle['train.stage'] == pytest.approx(6e-6 + 5e-6)
  assert idle['train.replay'] == pytest.approx(25e-6 + 10e-6 - 4e-6)
  assert idle[spans.OUTSIDE] == pytest.approx(10e-6)
  stolen = trace.profiler_idle_s()
  assert sum(idle.values()) == pytest.approx(
      trace.window_s - stolen - trace.busy_s())
  assert 100 * sum(idle.values()) / (trace.window_s - stolen) == \
      pytest.approx(trace.idle_share())


def test_span_table_is_the_programs():
  from gencast_tpu_torch import utils
  assert spans.SPANS == tuple((s.name, s.host, s.device, s.gradient,
                               s.parent) for s in utils.SPANS)
  assert spans.HOST_PREFIX == utils.HOST_PREFIX
  assert spans.MARKS == {utils.mark_name(*mk): mk for mk in utils.MARKS}
  assert spans.CHILDREN['denoiser'] == tuple(
      s.name for s in utils.SPANS if s.parent == 'denoiser')
