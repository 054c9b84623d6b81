"""The program's spans (`gencast_tpu_torch.utils.span`, `gradient_mark`) on
the CPU, at TINY: the order of the marks a sampled forecast step and a
fused training step leave in a profiler's trace, no host span without a
profiler, the same bits with and without one, and the mark kernels of
`csrc/span_mark.cu` against the program's table.

On the CPU a mark is a zero-length host span of its kernel's name while a
profiler records; on the card it is that kernel, and a graph replay runs
it (the benchmark's traced runs read them: `perfbench/lib/spans.py`).
"""

import os
import re

import numpy as np
import pytest
import torch

from gencast_tpu_torch import configs, utils
from gencast_tpu_torch.data import layout
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.ops import cuda_lib
from gencast_tpu_torch.parallel import ensemble
from gencast_tpu_torch.training import steps
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYERS = ('grid2mesh', 'processor', 'mesh2grid')


def _recorded(fn):
  """fn()'s result and the program's spans and marks it recorded under a
  CPU profiler, in order: mark kernel names and `gencast.*` host spans."""
  prof = torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU])
  prof.start()
  try:
    out = fn()
  finally:
    prof.stop()
  events = sorted((e.time_range.start, e.id, e.name) for e in prof.events()
                  if e.name.startswith(('gt_span_', utils.HOST_PREFIX)))
  return out, [name for _, _, name in events]


def _model():
  model, _ = configs.build_gencast(configs.TINY_PALLAS, seed=0,
                                   device='cpu')
  return model


def _window(model, seed=1):
  d = model.denoiser
  g = torch.Generator().manual_seed(seed)
  grid = (1, d.num_lat, d.num_lon)
  return (torch.randn(grid + (d.input_layout.num_channels,), generator=g),
          torch.randn(grid + (d.forcing_layout.num_channels,), generator=g))


def _stack():
  spec = configs.TINY_PALLAS
  model, _ = configs.build_gencast(spec, seed=0, device='cpu')
  task = spec.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  stack = wrappers.build_stack(model, stats, bf16=False)
  d = model.denoiser
  rng = np.random.default_rng(1)
  pool = {name: torch.as_tensor(rng.standard_normal(
      (3, 1, d.num_lat, d.num_lon, lay.num_channels)), dtype=torch.float32)
          for name, lay in (('inputs', d.input_layout),
                            ('targets', d.target_layout),
                            ('forcings', d.forcing_layout))}
  opt = steps.create_optimizer(stack, steps.OptimizerConfig(total_steps=100))
  return stack, opt, pool


def _mark(span, edge):
  return utils.mark_name(span, edge)


def test_a_forecast_step_marks_every_denoiser_call_and_draw():
  model = _model()
  inputs, forcings = _window(model)
  n = model.sampler_config.num_noise_levels
  _, names = _recorded(lambda: model.sample(
      inputs, forcings, torch.Generator().manual_seed(2)))
  marks = [m for m in names if m.startswith('gt_span_')]
  # The denoiser regions, each with the three layers in order.
  regions, outside, current = [], [], None
  for m in marks:
    if m == _mark('denoiser', 'begin'):
      current = []
    elif m == _mark('denoiser', 'end'):
      regions.append(current)
      current = None
    elif current is not None:
      current.append(m)
    else:
      outside.append(m)
  assert len(regions) == 2 * n - 1
  want = [_mark(layer, edge) for layer in LAYERS for edge in ('begin', 'end')]
  assert all(r == want for r in regions)
  # Between the calls only the draws, each a noise span: the initial
  # state's, and one per level where the sampler churns.
  draws = 1 + n * (model.sampler_config.stochastic_churn_rate > 0)
  assert outside == [_mark('noise', 'begin'), _mark('noise', 'end')] * draws
  assert names.count(utils.HOST_PREFIX + 'noise') == draws
  calls = [m for m in names if m.startswith('gencast.sample.call')]
  assert calls == [f'gencast.sample.call level={k // 2} call={k}'
                   for k in range(2 * n - 1)]
  # No gradient marks where nothing records gradients.
  assert not [m for m in marks if m.endswith('_grad')]


def test_a_training_step_marks_forward_backward_remat_and_optimizer():
  stack, opt, pool = _stack()
  fused = steps.scanned_train_steps(stack, opt)
  _, names = _recorded(lambda: fused(pool, [1], [7], 5))
  assert names[0] == 'gencast.train.stage step=7'
  marks = [m for m in names if m.startswith('gt_span_')]
  back = marks.index(_mark('backward', 'begin'))
  end = marks.index(_mark('backward', 'end'))
  forward, backward, after = marks[:back], marks[back + 1:end], marks[end + 1:]
  # The draws are staged before the step, outside every layer.
  assert forward[:2] == [_mark('noise', 'begin'), _mark('noise', 'end')]
  layers = [m for m in forward if not m.startswith('gt_span_remat')]
  assert layers[2:] == [_mark('denoiser', 'begin')] + [
      _mark(layer, edge) for layer in LAYERS
      for edge in ('begin', 'end')] + [_mark('denoiser', 'end')]
  # TINY's 'full' remat: each transformer block checkpointed, inside the
  # processor in the forward pass, its begin and end marks paired.
  blocks = configs.TINY_PALLAS.num_layers
  proc = forward[forward.index(_mark('processor', 'begin')):
                 forward.index(_mark('processor', 'end'))]
  assert proc[1:] == [_mark('remat', 'begin'), _mark('remat', 'end')] * blocks
  # The backward: the gradient marks in reverse order, the blocks'
  # recomputation inside the processor's gradient region (stopped early:
  # no end mark), then the optimizer after the backward.
  grads = [m for m in backward if m.endswith('_grad')]
  assert grads == [_mark(s, 'grad') for s in
                   ('denoiser', 'mesh2grid', 'processor', 'grid2mesh')]
  recomputed = backward[backward.index(_mark('processor', 'grad')) + 1:
                        backward.index(_mark('grid2mesh', 'grad'))]
  assert recomputed.count(_mark('remat', 'begin')) == blocks
  assert set(recomputed) <= {_mark('remat', 'begin'), _mark('remat', 'end')}
  assert after == [_mark('optimizer', 'begin'), _mark('optimizer', 'end')]


def test_no_host_span_is_entered_without_a_profiler(monkeypatch):
  entered = []
  real = torch.profiler.record_function

  def counting(*args, **kwargs):
    entered.append(args[0])
    return real(*args, **kwargs)

  monkeypatch.setattr(torch.profiler, 'record_function', counting)
  assert not utils.profiling()
  model = _model()
  inputs, forcings = _window(model)
  model.sample(inputs, forcings, torch.Generator().manual_seed(2))
  stack, opt, pool = _stack()
  steps.scanned_train_steps(stack, opt)(pool, [0, 2], [0, 1], 5)
  assert entered == []
  # The same calls under a profiler enter them.
  _recorded(lambda: model.sample(inputs, forcings,
                                 torch.Generator().manual_seed(2)))
  assert 'gencast.noise' in entered


def test_spans_leave_the_bits_as_they_were():
  """A sampled step graphed (eager here) and eager, with and without a
  profiler, and fused training steps with and without one: equal bits."""
  model = _model()
  inputs, forcings = _window(model)

  def sample(graphed):
    return model.sample(inputs, forcings, torch.Generator().manual_seed(2),
                        graphed=graphed)

  plain = sample(False)
  assert torch.equal(sample(True), plain)
  assert torch.equal(_recorded(lambda: sample(True))[0], plain)

  def train(profiled):
    stack, opt, pool = _stack()
    fused = steps.scanned_train_steps(stack, opt)

    def run():
      return fused(pool, [1, 0], [0, 1], 5)

    losses = _recorded(run)[0] if profiled else run()
    return losses, [p.detach().clone() for p in stack.parameters()]

  (want, params), (got, after) = train(False), train(True)
  assert torch.equal(got, want)
  assert all(torch.equal(a, b) for a, b in zip(after, params))


def test_gradient_mark_is_the_identity():
  w = torch.randn(4, 3, requires_grad=True)
  a, b = w * 2.0, w.sum(0)
  a2, b2 = utils.gradient_mark('grid2mesh', a, b)
  assert torch.equal(a2, a) and torch.equal(b2, b)
  (a2.square().sum() + b2.sum()).backward()
  ref = w.detach().clone().requires_grad_(True)
  ((ref * 2.0).square().sum() + ref.sum(0).sum()).backward()
  assert torch.equal(w.grad, ref.grad)
  # Nothing records gradients: the tensors come back as they were.
  with torch.no_grad():
    x = torch.ones(2)
    assert utils.gradient_mark('processor', x) is x


def test_a_block_that_raises_has_no_end_mark():

  def run():
    with pytest.raises(ValueError):
      with utils.span('remat', torch.device('cpu')):
        raise ValueError('stop')

  _, names = _recorded(run)
  assert names == [_mark('remat', 'begin')]


def test_member_chunks_name_their_members():
  model = _model()
  inputs, forcings = _window(model)
  _, names = _recorded(lambda: ensemble.ensemble_rollout(
      model, inputs, forcings[None], seed=3, num_members=3, member_chunk=2))
  assert [m for m in names if m.startswith('gencast.ensemble')] == [
      'gencast.ensemble.rollout members=0-2',
      'gencast.ensemble.rollout members=2-3']


def test_mark_kernels_are_the_programs_table():
  with open(os.path.join(cuda_lib.CSRC_DIR, 'span_mark.cu')) as f:
    source = f.read()
  table = source[source.index('#define GT_SPAN_MARKS'):]
  table = table[:table.index('\n\n')]
  kernels = re.findall(r'X\((\w+)\)', table)
  assert kernels == [f'{s}_{e}' for s, e in utils.MARKS]
  assert {s for s, _ in utils.MARKS} == {s.name for s in utils.SPANS
                                         if s.device}
  for s in utils.SPANS:
    assert (s.name, 'grad') in utils.MARKS or not s.gradient
    assert s.parent is None or s.gradient
