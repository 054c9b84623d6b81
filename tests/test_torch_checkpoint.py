"""Checkpoints, resume, metrics and stats files of the port's training CLI,
on CPU at the TINY preset.

The stats files and the metrics lines are held to the JAX package's own
code (`gencast_tpu.data.sources.save_stats`/`load_stats`,
`gencast_tpu.training.metrics_sink.MetricsSink`); the checkpoints, the
resume and the per-step noise to the reference's behaviour: parameters and
the optimizer's state with its step survive a save and restore, the newest
three are kept, and step s draws the same noise whether or not the run was
interrupted before it.
"""

import json
import os

import numpy as np
import pytest
import torch

from gencast_tpu.data import layout as jax_layout
from gencast_tpu.data import sources as jax_sources
from gencast_tpu.training import metrics_sink as jax_metrics_sink
from gencast_tpu_torch import configs
from gencast_tpu_torch.data import layout, sources
from gencast_tpu_torch.models import casting, wrappers
from gencast_tpu_torch.training import checkpoint, steps, train
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY_ARGV = ['--preset', 'tiny_pallas', '--data', 'synthetic', '--device',
             'cpu', '--log_every', '1']


def _stack(seed, bf16=False):
  spec = configs.TINY_PALLAS
  model, statics = configs.build_gencast(spec, seed=seed, device='cpu')
  task = spec.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  return model, wrappers.build_stack(model, stats, bf16=bf16)


def _batch(model, seed=0):
  d = model.denoiser
  g = torch.Generator().manual_seed(seed)
  grid = (1, d.num_lat, d.num_lon)
  return [torch.randn(grid + (lay.num_channels,), generator=g)
          for lay in (d.input_layout, d.target_layout, d.forcing_layout)]


def _optimizer(stack):
  return steps.create_optimizer(stack, steps.OptimizerConfig(
      learning_rate=1e-3, warmup_steps=2, total_steps=10))


def _train(stack, optimizer, model, num_steps):
  for s in range(num_steps):
    steps.train_step(stack, optimizer, *_batch(model),
                     train.step_generator(0, s, 'cpu'))


def test_round_trip_restores_parameters_and_optimizer(tmp_path):
  model, stack = _stack(seed=1)
  optimizer = _optimizer(stack)
  _train(stack, optimizer, model, 2)
  manager = checkpoint.create_manager(str(tmp_path))
  checkpoint.save(manager, 7, stack, optimizer)

  model2, stack2 = _stack(seed=2)
  optimizer2 = _optimizer(stack2)
  assert checkpoint.latest_step(manager) == 7
  assert checkpoint.restore(manager, stack2, optimizer2) == 7
  for (n, p), (n2, p2) in zip(stack.named_parameters(),
                              stack2.named_parameters()):
    assert n == n2 and torch.equal(p, p2), n
  assert optimizer2.step_count == optimizer.step_count == 2
  want, got = optimizer.adamw.state_dict(), optimizer2.adamw.state_dict()
  assert want['state'].keys() == got['state'].keys()
  for i, moments in want['state'].items():
    for key in ('step', 'exp_avg', 'exp_avg_sq'):
      assert torch.equal(moments[key], got['state'][i][key]), (i, key)
  # Both continue identically: the warmup-cosine schedule resumes at step 2.
  _train(stack, optimizer, model, 1)
  _train(stack2, optimizer2, model2, 1)
  for p, p2 in zip(stack.parameters(), stack2.parameters()):
    assert torch.equal(p, p2)


def test_retention_keeps_the_newest_three(tmp_path):
  _, stack = _stack(seed=1)
  manager = checkpoint.create_manager(str(tmp_path))
  for step in range(5):
    checkpoint.save(manager, step, stack)
  assert checkpoint.all_steps(manager) == [2, 3, 4]
  assert sorted(os.listdir(tmp_path)) == ['step_2.pt', 'step_3.pt',
                                          'step_4.pt']


def test_serving_after_restore_equals_serving_before_save(tmp_path):
  """The bf16 serving copy lives outside state_dict: the restore refreshes
  it, so the restored stack serves the saved weights, not its own."""
  model, stack = _stack(seed=1, bf16=True)
  _train(stack, _optimizer(stack), model, 1)
  casting.refresh_all(stack)
  inputs, noisy, forcings = _batch(model, seed=3)
  sigma = torch.full((1,), 2.0)
  with torch.no_grad():
    before = stack(inputs, noisy, sigma, forcings)
  manager = checkpoint.create_manager(str(tmp_path))
  checkpoint.save(manager, 0, stack)

  _, stack2 = _stack(seed=2, bf16=True)
  with torch.no_grad():
    fresh = stack2(inputs, noisy, sigma, forcings)
    checkpoint.restore(manager, stack2)
    after = stack2(inputs, noisy, sigma, forcings)
  assert not torch.equal(fresh, before)
  assert torch.equal(after, before)


def test_restore_refuses_other_parameters(tmp_path):
  _, stack = _stack(seed=1)
  manager = checkpoint.create_manager(str(tmp_path))
  checkpoint.save(manager, 0, stack)
  _, bf16_stack = _stack(seed=1, bf16=True)  # names under the cast wrapper
  with pytest.raises(KeyError, match='other parameters'):
    checkpoint.restore(manager, bf16_stack)


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
  """The train CLI on TINY: 4 steps uninterrupted, and 2 steps then a run to
  step 4 that resumes, each recording the generator state every step
  starts from; the first run writes --stats_path, the others read it."""
  root = tmp_path_factory.mktemp('cli')
  stats_path = str(root / 'stats.npz')
  starts = {}
  real = train.step_generator

  def recording(key):
    def step_generator(seed, step, device):
      gen = real(seed, step, device)
      starts.setdefault(key, {})[step] = gen.get_state().clone()
      return gen
    return step_generator

  runs = {}
  with pytest.MonkeyPatch.context() as mp:
    for key, argv in (
        ('whole', ['--steps', '4', '--ckpt_dir', str(root / 'whole')]),
        ('first', ['--steps', '2', '--save_every', '1', '--ckpt_dir',
                   str(root / 'split'), '--metrics_jsonl',
                   str(root / 'metrics.jsonl')]),
        ('resumed', ['--steps', '4', '--ckpt_dir', str(root / 'split'),
                     '--metrics_jsonl', str(root / 'metrics.jsonl')])):
      mp.setattr(train, 'step_generator', recording(key))
      runs[key] = train.main(TINY_ARGV + argv + ['--stats_path', stats_path])
  return dict(root=root, runs=runs, starts=starts, stats_path=stats_path)


def test_train_cli_resumes_from_the_newest_checkpoint(cli_runs):
  runs = cli_runs['runs']
  assert runs['first'].start_step == 0 and len(runs['first'].losses) == 2
  assert runs['resumed'].start_step == 2 and len(runs['resumed'].losses) == 2
  manager = checkpoint.create_manager(str(cli_runs['root'] / 'split'))
  # Saved after steps 0 and 1 (--save_every 1), and at the end: step 3.
  assert checkpoint.all_steps(manager) == [0, 1, 3]
  state = torch.load(os.path.join(manager.directory, 'step_3.pt'),
                     weights_only=True)
  assert state['opt_state']['step_count'] == 4
  for name, p in runs['resumed'].model.named_parameters():
    assert torch.equal(p, state['params'][name]), name


def test_step_noise_is_the_same_after_a_resume(cli_runs):
  starts = cli_runs['starts']
  assert sorted(starts['whole']) == [0, 1, 2, 3]
  assert sorted(starts['resumed']) == [2, 3]
  for step in (2, 3):
    assert torch.equal(starts['resumed'][step], starts['whole'][step])
  assert not torch.equal(starts['whole'][2], starts['whole'][3])
  assert torch.equal(starts['first'][1], starts['whole'][1])


def test_metrics_lines_have_the_reference_keys(cli_runs, tmp_path):
  with open(cli_runs['root'] / 'metrics.jsonl') as f:
    events = [json.loads(line) for line in f]
  assert [(e['event'], e['step']) for e in events] == [
      ('train', s) for s in (1, 2, 3, 4)]
  sink = jax_metrics_sink.MetricsSink(str(tmp_path / 'jax.jsonl'))
  sink.log('train', 1, loss=1.0, steps_per_sec=2.0)
  sink.close()
  with open(tmp_path / 'jax.jsonl') as f:
    want = json.loads(f.readline()).keys()
  assert all(e.keys() == want for e in events)


def _assert_stats_equal(a, b):
  for table in ('mean', 'std', 'diffs_std'):
    ta, tb = getattr(a, table), getattr(b, table)
    assert ta.keys() == tb.keys()
    for name in ta:
      np.testing.assert_array_equal(np.asarray(ta[name]),
                                    np.asarray(tb[name]))


def test_stats_files_load_in_both_packages(cli_runs, tmp_path):
  """--stats_path written by the port's CLI loads in the JAX package to the
  stats the port computed; a file the JAX package writes loads in the
  port's."""
  lat, lon = configs.grid_for_resolution(configs.TINY.resolution_deg)
  source = sources.SyntheticSource(configs.TINY.task, lat, lon, num_times=40,
                                   seed=0)  # the CLI's, at --seed 0
  computed = sources.compute_stats(source)
  _assert_stats_equal(jax_sources.load_stats(cli_runs['stats_path']),
                      computed)
  jax_path = str(tmp_path / 'jax_stats.npz')
  jax_sources.save_stats(jax_layout.Stats(computed.mean, computed.std,
                                          computed.diffs_std), jax_path)
  _assert_stats_equal(sources.load_stats(jax_path), computed)
  _assert_stats_equal(sources.load_stats_auto(jax_path), computed)


def test_netcdf_stats_directories_load_as_in_the_jax_package(tmp_path):
  """A --stats_path directory (DeepMind's published NetCDF statistics, as
  the JAX package's synthesizer writes them) loads to the JAX loader's
  tables; refused until the ERA5 data path was ported."""
  pytest.importorskip('h5py')
  from tools import synth_era5 as jax_synth
  jax_synth.synthesize_stats(str(tmp_path), seed=3)
  levels = configs.TINY.task.pressure_levels
  _assert_stats_equal(sources.load_stats_auto(str(tmp_path), levels),
                      jax_sources.load_stats_auto(str(tmp_path), levels))


@pytest.mark.parametrize('argv,dest,value', [
    (['--profile_dir', 'traces'], 'profile_dir', 'traces'),
    (['--prefetch', '2'], 'prefetch', 2),
    (['--data_workers', '2'], 'data_workers', 2),
])
def test_train_cli_takes_the_input_pipeline_flags(argv, dest, value):
  """--profile_dir, --prefetch and --data_workers, refused until the ERA5
  data path was ported, parse as in the reference's CLI."""
  from gencast_tpu.training import train as jax_train
  args = train.parse_args(['--preset', 'tiny'] + argv)
  assert getattr(args, dest) == value
  assert getattr(jax_train.parse_args(['--preset', 'tiny'] + argv),
                 dest) == value


@pytest.mark.parametrize('argv,match', [
    # GraphCast, refused until it was ported, parses (match None).
    pytest.param(['--model', 'graphcast'], None, id='argv0-GraphCast'),
    # The reference's einsum 'dense' attention, refused until it was ported,
    # trains (match None).
    pytest.param(['--attention_type', 'dense'], None,
                 id='argv1-other attention backends'),
])
def test_train_cli_refuses_what_is_not_ported(argv, match, capsys, tmp_path):
  if match is None and '--model' in argv:
    assert train.parse_args(['--preset', 'tiny'] + argv).model == 'graphcast'
    return
  if match is None:
    run = train.main(['--preset', 'tiny', '--data', 'synthetic', '--device',
                      'cpu', '--steps', '2', '--ckpt_dir',
                      str(tmp_path)] + argv)
    assert 'attention=dense' in capsys.readouterr().out
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    processor = wrappers.find_layout_provider(run.model).architecture.processor
    assert type(processor.blocks[0].attn).__name__ == 'DenseAttention'
    return
  with pytest.raises(SystemExit):
    train.parse_args(['--preset', 'tiny'] + argv)
  assert match in capsys.readouterr().err
