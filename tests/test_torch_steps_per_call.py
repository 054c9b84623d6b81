"""The port's fused dispatch on CPU: `steps.scanned_train_steps` and the
training CLI's `--steps_per_call` / `--pool_size`, and the sampler's
`jit` flag, at the TINY preset.

On the card a fused step replays one CUDA graph and the sampler replays one
of its denoiser call; `chip_smoke.py` holds those replays to the eager
path's bits. Here, on the CPU, the same staging and step run eagerly, and
are held to the per-step loop bit for bit (the JAX side's own equivalence
test, `tests/test_fused_training.py`, holds its scan to 2e-5), and the pool
rows and step numbers of each fused call to the JAX CLI's.
"""

import argparse
import copy
import json
import types

import flax.nnx as nnx
import numpy as np
import pytest
import torch

from gencast_tpu.training import steps as jax_steps
from gencast_tpu.training import train as jax_train
from gencast_tpu_torch import configs, rollout
from gencast_tpu_torch.data import layout
from gencast_tpu_torch.models import casting, wrappers
from gencast_tpu_torch.ops import cuda_lib
from gencast_tpu_torch.parallel import ensemble
from gencast_tpu_torch.training import checkpoint, steps, train
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _stack(seed=0, bf16=False):
  spec = configs.TINY_PALLAS
  model, _ = configs.build_gencast(spec, seed=seed, device='cpu')
  task = spec.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  return model, wrappers.build_stack(model, stats, bf16=bf16)


def _pool(model, m=3, seed=1):
  d = model.denoiser
  rng = np.random.default_rng(seed)
  return {name: torch.as_tensor(rng.standard_normal(
      (m, 1, d.num_lat, d.num_lon, lay.num_channels)), dtype=torch.float32)
          for name, lay in (('inputs', d.input_layout),
                            ('targets', d.target_layout),
                            ('forcings', d.forcing_layout))}


def _optimizer(stack):
  return steps.create_optimizer(stack, steps.OptimizerConfig(total_steps=100))


def test_scanned_steps_equal_the_per_step_loop_bitwise():
  """(a) Four fused steps on pool rows [1, 0, 2, 1] give the losses and
  parameters of four `train_step` calls with the same rows and step
  generators, bit for bit: the fused step draws outside its step
  (`GenCast.training_draws`), the loss inside the per-step call, from the
  same generator."""
  model_a, stack_a = _stack()
  model_b, stack_b = _stack()
  opt_a, opt_b = _optimizer(stack_a), _optimizer(stack_b)
  pool = _pool(model_a)
  idx, step_ids, seed = [1, 0, 2, 1], [0, 1, 2, 3], 7
  per_step = []
  for i, s in zip(idx, step_ids):
    loss, _ = steps.train_step(stack_a, opt_a, pool['inputs'][i],
                               pool['targets'][i], pool['forcings'][i],
                               train.step_generator(seed, s, 'cpu'))
    per_step.append(loss)
  fused = steps.scanned_train_steps(stack_b, opt_b)
  losses = fused(pool, idx, step_ids, seed)
  assert losses.dtype == torch.float32 and losses.shape == (4,)
  assert torch.equal(losses, torch.stack(per_step))
  params = list(zip(model_a.parameters(), model_b.parameters()))
  assert params and all(torch.equal(a, b) for a, b in params)
  assert opt_a.step_count == opt_b.step_count == 4
  # The CPU runs the step eagerly: no graph.
  assert fused.graph is None


def test_scanned_steps_continue_across_calls():
  """Two calls of two steps are the four steps of one call."""
  model_a, stack_a = _stack()
  model_b, stack_b = _stack()
  pool = _pool(model_a)
  one = steps.scanned_train_steps(stack_a, _optimizer(stack_a))
  two = steps.scanned_train_steps(stack_b, _optimizer(stack_b))
  whole = one(pool, [2, 0, 1, 1], range(4), 3)
  parts = torch.cat([two(pool, [2, 0], [0, 1], 3), two(pool, [1, 1], [2, 3],
                                                       3)])
  assert torch.equal(whole, parts)
  assert all(torch.equal(a, b) for a, b in zip(model_a.parameters(),
                                               model_b.parameters()))


def test_scanned_steps_refuse_ar_and_mismatched_rows():
  """ar=True, refused until GraphCast was ported, trains a GraphCast's
  autoregressive loss over pool windows of K frames: three fused steps
  equal three `ar_train_step`s bit for bit. It still refuses a model that
  draws (GenCast: its draws would be frozen into the step's graph), and
  every fused call refuses rows that do not match its steps."""
  _, stack = _stack()
  with pytest.raises(ValueError, match='deterministic'):
    steps.scanned_train_steps(stack, _optimizer(stack), ar=True)
  twins = []
  for _ in range(2):
    model, _ = configs.build_graphcast(configs.TINY, device='cpu',
                                       cache_dir=None)
    twins.append(wrappers.build_stack(model, layout.Stats.unit(
        sorted(set(model.task.input_variables
                   + model.task.target_variables)),
        model.task.pressure_levels), bf16=False))
  model = twins[0].predictor
  rng = np.random.default_rng(2)
  k_ar, grid = 2, (model.num_lat, model.num_lon)
  pool = {name: torch.as_tensor(rng.standard_normal(
      (3,) + lead + grid + (lay.num_channels,)), dtype=torch.float32)
          for name, lead, lay in (('inputs', (1,), model.input_layout),
                                  ('targets', (k_ar, 1), model.target_layout),
                                  ('forcings', (k_ar, 1),
                                   model.forcing_layout))}
  fused = steps.scanned_train_steps(twins[0], _optimizer(twins[0]), ar=True)
  got = fused(pool, [2, 0, 2], range(3), 0)
  opt = _optimizer(twins[1])
  want = [steps.ar_train_step(twins[1], opt, pool['inputs'][r],
                              pool['targets'][r], pool['forcings'][r])[0]
          for r in (2, 0, 2)]
  assert torch.equal(got, torch.stack(want))
  assert all(torch.equal(a, b) for a, b in zip(twins[0].parameters(),
                                               twins[1].parameters()))
  fused = steps.scanned_train_steps(stack, _optimizer(stack))
  with pytest.raises(ValueError, match='pool rows'):
    fused(_pool(stack.predictor), [0, 1], [0], 0)


def test_loss_takes_both_draws_or_neither():
  model, stack = _stack()
  inputs, targets, forcings = (p[0] for p in _pool(model).values())
  with pytest.raises(ValueError, match='both sigma and noise'):
    stack.loss(inputs, targets, forcings, sigma=torch.ones(1))
  with pytest.raises(ValueError, match='generator'):
    stack.loss(inputs, targets, forcings)


def test_training_draws_are_the_losses():
  """The loss with a generator equals the loss with that generator's
  `training_draws` injected."""
  model, stack = _stack()
  inputs, targets, forcings = (p[0] for p in _pool(model).values())
  drawn = stack.loss(inputs, targets, forcings,
                     train.step_generator(5, 2, 'cpu'))[0]
  sigma, noise = model.training_draws(train.step_generator(5, 2, 'cpu'), 1)
  assert sigma.dtype == noise.dtype == torch.float32
  injected = stack.loss(inputs, targets, forcings, sigma=sigma,
                        noise=noise)[0]
  assert torch.equal(drawn, injected)


class _Source:
  """A stand-in data source: `size` windows of small random fields."""

  def __init__(self, size):
    rng = np.random.default_rng(0)
    self.windows = [types.SimpleNamespace(
        inputs=rng.standard_normal((2, 3, 4)).astype(np.float32),
        targets=rng.standard_normal((2, 3, 2)).astype(np.float32),
        forcings=rng.standard_normal((2, 3, 1)).astype(np.float32))
                    for _ in range(size)]

  def __len__(self):
    return len(self.windows)

  def sample(self, i, num_target_frames=1):
    assert num_target_frames == 1
    return self.windows[i]


class _Sink:

  def log(self, *args, **kwargs):
    pass

  def close(self):
    pass


def _args(**kwargs):
  base = dict(seed=0, steps=10, steps_per_call=3, pool_size=64,
              log_every=10**6, save_every=10**6, ckpt_dir=None)
  base.update(kwargs)
  return argparse.Namespace(**base)


@pytest.mark.parametrize('config', [
    dict(steps=10, steps_per_call=3, pool_size=4, seed=0, start=0),
    dict(steps=13, steps_per_call=4, pool_size=64, seed=5, start=0),
    dict(steps=9, steps_per_call=2, pool_size=3, seed=1, start=3),
])
def test_fused_calls_get_the_reference_rows_and_steps(config, monkeypatch):
  """(b) For the same --seed, --steps, --steps_per_call, --pool_size (and
  start step), each fused call of the port's CLI gets the pool rows and
  step numbers that the JAX CLI's `_run_fused` hands its fused_fn; both
  sides' `scanned_train_steps` are stand-ins that record them."""
  config = dict(config)
  start = config.pop('start')
  source = _Source(7)
  args = _args(**config)

  jax_calls = []

  def jax_stand_in(model, optimizer, ar=False):
    def fused_fn(state, pool, idx, key, step_ids):
      jax_calls.append((list(map(int, idx)), list(map(int, step_ids)),
                        int(pool['inputs'].shape[0])))
      return state, np.zeros(len(idx), np.float32)
    return fused_fn, None

  monkeypatch.setattr(jax_steps, 'scanned_train_steps', jax_stand_in)
  monkeypatch.setattr(nnx, 'update', lambda *a: None)
  jax_train._run_fused(args, source, None, None, None, _Sink(), start)

  port_calls = []

  def port_stand_in(model, optimizer, ar=False):
    def fused_fn(pool, idx, step_ids, seed):
      assert seed == args.seed
      port_calls.append((list(map(int, idx)), list(map(int, step_ids)),
                         int(pool['inputs'].shape[0])))
      return torch.zeros(len(idx))
    return fused_fn

  monkeypatch.setattr(steps, 'scanned_train_steps', port_stand_in)
  setup = types.SimpleNamespace(source=source, wrapped=None, optimizer=None,
                                device=torch.device('cpu'), ar_steps=1)
  run = train.TrainRun(model=None, losses=[], step_seconds=[],
                       start_step=start)
  train._run_fused(args, setup, None, _Sink(), run)
  assert port_calls == jax_calls and port_calls
  assert len(run.losses) == len(run.step_seconds) == args.steps - start


def test_device_pool_stacks_the_first_samples():
  source = _Source(5)
  pool = train.device_pool(source, 3, torch.device('cpu'))
  for name in ('inputs', 'targets', 'forcings'):
    want = np.stack([getattr(w, name)[None] for w in source.windows[:3]])
    assert pool[name].dtype == torch.float32
    np.testing.assert_array_equal(pool[name].numpy(), want)


def test_cli_fused_smoke_and_resume(tmp_path, capsys):
  """(c) 4 fused steps, 2 per call, logged every 2 and saved at step 4;
  then a run to step 6 resumes from that checkpoint through the fused
  path."""
  metrics = str(tmp_path / 'metrics.jsonl')
  ckpt = str(tmp_path / 'ckpt')
  argv = ['--preset', 'tiny_pallas', '--data', 'synthetic', '--device', 'cpu',
          '--steps_per_call', '2', '--ckpt_dir', ckpt]
  run = train.main(argv + ['--steps', '4', '--log_every', '2',
                           '--save_every', '4', '--metrics_jsonl', metrics])
  out = capsys.readouterr().out
  assert 'fused mode: 2 steps/call, device pool of 38 samples' in out
  with open(metrics) as f:
    events = [json.loads(line) for line in f]
  assert [(e['event'], e['step']) for e in events] == [('train', 2),
                                                        ('train', 4)]
  assert all(np.isfinite(e['loss']) for e in events)
  assert len(run.losses) == 4 and np.isfinite(run.losses).all()
  manager = checkpoint.create_manager(ckpt)
  assert checkpoint.all_steps(manager) == [3]
  resumed = train.main(argv + ['--steps', '6'])
  out = capsys.readouterr().out
  assert 'resumed from step 3' in out and 'fused mode' in out
  assert resumed.start_step == 4 and len(resumed.losses) == 2
  assert checkpoint.all_steps(manager) == [3, 5]
  state = torch.load(f'{ckpt}/step_5.pt', weights_only=True)
  assert state['opt_state']['step_count'] == 6


def test_cli_falls_back_to_per_step_above_batch_one(capsys):
  run = train.main(['--preset', 'tiny_pallas', '--data', 'synthetic',
                    '--device', 'cpu', '--steps', '2', '--batch_size', '2',
                    '--steps_per_call', '2'])
  out = capsys.readouterr().out
  assert ('fused steps_per_call requires batch_size=1 and no mesh; falling '
          'back to per-step dispatch') in out
  assert 'fused mode' not in out and len(run.losses) == 2


def test_cli_refuses_an_empty_pool(capsys):
  with pytest.raises(SystemExit):
    train.parse_args(['--preset', 'tiny', '--pool_size', '0'])
  assert '--pool_size must be positive' in capsys.readouterr().err


def _window(model, steps_k=2, seed=3):
  d = model.denoiser
  g = torch.Generator().manual_seed(seed)
  grid = (1, d.num_lat, d.num_lon)
  inputs = torch.randn(grid + (d.input_layout.num_channels,), generator=g)
  forcings = torch.randn((steps_k,) + grid
                         + (d.forcing_layout.num_channels,), generator=g)
  return inputs, forcings


def test_sample_rollout_jit_equals_eager_on_the_cpu():
  """(d) On the CPU both settings of `jit` run every call eagerly."""
  model, stack = _stack(bf16=True)
  inputs, forcings = _window(model)
  graphed = rollout.sample_rollout(stack, inputs, forcings,
                                   torch.Generator().manual_seed(1))
  eager = rollout.sample_rollout(stack, inputs, forcings,
                                 torch.Generator().manual_seed(1), jit=False)
  assert torch.isfinite(graphed).all() and torch.equal(graphed, eager)
  members = ensemble.ensemble_rollout(stack, inputs, forcings, seed=0,
                                      num_members=2, jit=False)
  assert torch.equal(members, ensemble.ensemble_rollout(
      stack, inputs, forcings, seed=0, num_members=2))


def test_refresh_serves_the_new_masters():
  """(e) After the masters change and `refresh_all`, the next sample
  differs from the one before; the serving copy is refreshed in place and
  keeps its sampler graphs, whose captured parameters now hold the new
  values."""
  model, stack = _stack(bf16=True)
  inputs, forcings = _window(model, steps_k=1)
  cast = next(m for m in stack.modules()
              if isinstance(m, casting.Bfloat16Cast))

  def sample():
    return stack.sample(inputs, forcings[0], torch.Generator().manual_seed(2))

  before = sample()
  graphs = cast._bf16.denoiser_graphs
  with torch.no_grad():
    for p in model.parameters():
      p.add_(0.05)
  assert torch.equal(sample(), before)  # the copy serves until refreshed
  casting.refresh_all(stack)
  after = sample()
  assert torch.isfinite(after).all() and not torch.equal(after, before)
  assert cast._bf16.denoiser_graphs is graphs


def test_refresh_in_place_gives_a_fresh_copys_bits():
  """After a training step has changed the masters, a refresh copies them
  into the serving copy's own bf16 parameters (the addresses a captured
  graph reads stay valid): bitwise a fresh `cast_params` copy, buffers
  still shared with the masters. A serving copy of a model laid out anew
  (here sharded over a model axis of one rank's slices) is made anew."""
  from gencast_tpu_torch.parallel import tensor
  model, stack = _stack(bf16=True)
  cast = next(m for m in stack.modules()
              if isinstance(m, casting.Bfloat16Cast))
  twin = cast._bf16
  addresses = [p.data_ptr() for p in twin.parameters()]
  optimizer = steps.create_optimizer(stack, steps.OptimizerConfig(
      learning_rate=1e-2, warmup_steps=0, total_steps=4))
  pool = _pool(model, m=1)
  for step in range(2):  # the first update's rate is 0
    steps.train_step(stack, optimizer, pool['inputs'][0],
                     pool['targets'][0], pool['forcings'][0],
                     train.step_generator(0, step, 'cpu'))
  fresh = casting.cast_params(model)
  assert not all(torch.equal(a, b) for a, b in zip(twin.parameters(),
                                                   fresh.parameters()))
  casting.refresh_all(stack)
  assert cast._bf16 is twin
  assert [p.data_ptr() for p in twin.parameters()] == addresses
  for (name, p), q in zip(twin.named_parameters(), fresh.parameters()):
    assert p.dtype == q.dtype == torch.bfloat16, name
    assert torch.equal(p.view(torch.int16), q.view(torch.int16)), name
  assert all(a is b for a, b in zip(twin.buffers(), model.buffers()))
  tensor.shard_model(stack, tensor.ModelAxis(None, 2, 0))
  casting.refresh_all(stack)
  assert cast._bf16 is not twin
  assert ([p.shape for p in cast._bf16.parameters()]
          == [p.shape for p in model.parameters()])


def test_denoiser_graphs_are_never_copied_or_moved():
  """A CUDA graph cannot be copied: a deep copy of a model (how the bf16
  serving copy is made) starts without graphs, and so does a model moved
  by `.to()`, whose parameters get new storage."""
  model, _ = _stack()
  model.denoiser_graphs.graphs['key'] = object()
  assert copy.deepcopy(model).denoiser_graphs.graphs == {}
  assert casting.cast_params(model).denoiser_graphs.graphs == {}
  assert model.denoiser_graphs.graphs  # the original keeps its own
  model.to('cpu')
  assert model.denoiser_graphs.graphs == {}
  assert isinstance(model.denoiser_graphs, cuda_lib.GraphedCalls)


def test_captured_launches_are_added_per_replay():
  """A capture takes back the counts its wrappers added (nothing ran) and
  keeps them; each replay adds them."""
  a, b = cuda_lib.COUNTERS[:2]
  before = (a.launches, b.launches)
  counts = cuda_lib.CapturedLaunches()
  with counts.recording():
    a.launches += 3
    b.launches += 1
  assert (a.launches, b.launches) == before
  for _ in range(2):
    counts.replayed()
  assert (a.launches, b.launches) == (before[0] + 6, before[1] + 2)
  a.launches, b.launches = before
  names = [c.name for c in cuda_lib.COUNTERS]
  assert len(names) == len(set(names)) == 11


def test_optimizer_state_round_trip_keeps_the_rate():
  model, stack = _stack()
  opt = _optimizer(stack)
  fused = steps.scanned_train_steps(stack, opt)
  fused(_pool(model), [0, 1], [0, 1], 0)
  saved = copy.deepcopy(opt.state_dict())
  _, stack2 = _stack(seed=1)
  opt2 = _optimizer(stack2)
  opt2.load_state_dict(saved)
  assert opt2.step_count == 2
  opt2.set_rate()
  assert opt2.adamw.param_groups[0]['lr'] == opt.schedule(2)
