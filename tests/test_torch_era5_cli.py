"""The training and evaluate CLIs on ERA5 directories, on the CPU at TINY.

One 10-degree corpus, written by the port's synthesizer in both layouts
(NetCDF files and npz shards): training, a resume and evaluate with
`--save_netcdf` from each; the two layouts are the same data, so the runs
are equal bit for bit. Also: `--prefetch` and `--data_workers` leave the
run's bits as they are, `--profile_dir` writes a trace of steps 10-15
(or of `--profile_steps`), published NetCDF stats feed `--stats_path`, and a directory too short for
one window is refused with the frames found and needed.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

h5py = pytest.importorskip('h5py')

from gencast_tpu.data import registry as jax_registry  # noqa: E402
from gencast_tpu.data import sources as jax_sources  # noqa: E402
from gencast_tpu_torch.data import layout, registry  # noqa: E402
from gencast_tpu_torch.tools import synth_era5  # noqa: E402
from gencast_tpu_torch.training import evaluate, train  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

FRAMES = 8
MEMBERS, STEPS = 2, 2
TINY = ['--preset', 'tiny_pallas', '--device', 'cpu', '--log_every', '1']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  root = tmp_path_factory.mktemp('cli_era5')
  dirs = {layout_name: str(root / layout_name)
          for layout_name in synth_era5.LAYOUTS}
  for layout_name, path in dirs.items():
    synth_era5.synthesize(path, resolution_deg=10.0,
                          steps_per_month=FRAMES, seed=4, layout=layout_name)
  synth_era5.synthesize_stats(str(root / 'stats'), seed=4)
  dirs['stats'] = str(root / 'stats')
  return dirs


@pytest.fixture(scope='module')
def runs(corpus, tmp_path_factory):
  """Per layout: 2 steps with a checkpoint, a resume to step 3, and a
  2-member, 2-step evaluate with --save_netcdf from the checkpoint."""
  out = {}
  for layout_name in synth_era5.LAYOUTS:
    root = tmp_path_factory.mktemp(f'run_{layout_name}')
    ckpt, ev = str(root / 'ckpt'), str(root / 'eval')
    argv = TINY + ['--data', corpus[layout_name], '--ckpt_dir', ckpt]
    first = train.main(argv + ['--steps', '2'])
    resumed = train.main(argv + ['--steps', '3'])
    evaluated = evaluate.main([
        '--preset', 'tiny_pallas', '--device', 'cpu',
        '--data', corpus[layout_name], '--ckpt_dir', ckpt,
        '--num_members', str(MEMBERS), '--max_rollout_steps', str(STEPS),
        '--out_dir', ev, '--save_netcdf',
        '--plot_vars'])
    out[layout_name] = (first, resumed, evaluated, ev)
  return out


@pytest.mark.parametrize('layout_name', synth_era5.LAYOUTS)
def test_train_resume_evaluate_from_an_era5_directory(runs, layout_name):
  first, resumed, evaluated, ev = runs[layout_name]
  assert (first.start_step, len(first.losses)) == (0, 2)
  assert (resumed.start_step, len(resumed.losses)) == (2, 1)
  assert np.isfinite(first.losses + resumed.losses).all()
  with open(os.path.join(ev, 'metrics.json')) as f:
    scores = json.load(f)
  assert (scores['steps'], scores['members']) == (STEPS, MEMBERS)
  assert np.isfinite(list(scores['crps'].values())).all()
  assert evaluated.predictions.shape[:2] == (MEMBERS, STEPS)


def test_both_layouts_give_the_same_run(runs):
  """The NetCDF files and the npz shards of one corpus are the same data:
  equal losses, parameters and forecasts, bit for bit."""
  a, b = runs['netcdf'], runs['npz']
  assert a[0].losses == b[0].losses and a[1].losses == b[1].losses
  for p, q in zip(a[1].model.parameters(), b[1].model.parameters()):
    assert torch.equal(p, q)
  np.testing.assert_array_equal(a[2].predictions, b[2].predictions)


def test_evaluate_truth_is_the_directorys_first_window(corpus, runs):
  """rollout.npz's truth is the source's first window, as the JAX
  package's Era5NpzSource packs it."""
  _, _, evaluated, ev = runs['npz']
  ref = jax_sources.Era5NpzSource(corpus['npz'], jax_registry.GENCAST_TASK)
  with np.load(os.path.join(ev, 'rollout.npz')) as z:
    np.testing.assert_array_equal(
        z['truth'], ref.sample(0, num_target_frames=STEPS).targets)
    np.testing.assert_array_equal(z['predictions'], evaluated.predictions)


def test_save_netcdf_writes_the_ensemble_mean_and_the_truth(runs):
  _, _, evaluated, ev = runs['netcdf']
  task = registry.GENCAST_TASK
  lay = layout.build_layout(task.target_variables, task.pressure_levels, 1)
  mean = evaluated.predictions.mean(axis=0)
  with np.load(os.path.join(ev, 'rollout.npz')) as z:
    truth = z['truth']
  with h5py.File(os.path.join(ev, 'rollout.nc'), 'r') as f:
    assert f.attrs['members'] == MEMBERS and f.attrs['steps'] == STEPS
    ch = lay.var_channels('2m_temperature')[0]
    np.testing.assert_array_equal(f['2m_temperature'][...], mean[..., ch])
    np.testing.assert_array_equal(f['target_2m_temperature'][...],
                                  truth[..., ch])
    assert f['temperature'].shape == (STEPS, 13, 19, 36)
    np.testing.assert_array_equal(f['time'][...],
                                  np.array([12.0, 24.0]) * 3600)


def test_prefetch_and_workers_leave_the_run_bitwise_the_same(corpus, capsys):
  """Equal bits either way; the run ends with a one-line summary of its
  batch waits and steps."""
  argv = TINY + ['--data', corpus['npz'], '--steps', '4']
  plain = train.main(argv + ['--prefetch', '0', '--data_workers', '0'])
  piped = train.main(argv + ['--prefetch', '2', '--data_workers', '2'])
  assert plain.losses == piped.losses
  for p, q in zip(plain.model.parameters(), piped.model.parameters()):
    assert torch.equal(p, q)
  assert len(piped.batch_seconds) == len(piped.step_seconds) == 4
  prefix = '[train] pipeline '
  summaries = [json.loads(line[len(prefix):])
               for line in capsys.readouterr().out.splitlines()
               if line.startswith(prefix)]
  assert [(s['prefetch'], s['data_workers'], s['steps'])
          for s in summaries] == [(0, 0, 4), (2, 2, 4)]
  wait, step = piped.batch_seconds, piped.step_seconds
  assert summaries[1]['batch_wait_s'] == {
      'first': wait[0], 'mean': np.mean(wait[1:]), 'max': max(wait[1:])}
  assert summaries[1]['step_s'] == {
      'first': step[0], 'mean': np.mean(step[1:]), 'max': max(step[1:])}


def test_profile_dir_writes_a_trace_of_steps_10_to_15(corpus, tmp_path,
                                                      capsys):
  trace_dir = str(tmp_path / 'trace')
  run = train.main(TINY + ['--data', corpus['npz'], '--steps', '16',
                           '--log_every', '8', '--profile_dir', trace_dir])
  assert len(run.losses) == 16
  with open(os.path.join(trace_dir, train.PROFILE_TRACE)) as f:
    events = json.load(f)['traceEvents']
  names = {e.get('name', '') for e in events}
  assert any(n.startswith('aten::') for n in names)
  assert 'profiler trace written to' in capsys.readouterr().out


def test_profile_steps_moves_the_traced_steps(corpus, tmp_path, capsys):
  """--profile_steps 1 2 traces steps 1-2 of a 3-step run, into a file
  named for them."""
  trace_dir = str(tmp_path / 'trace')
  run = train.main(TINY + ['--data', corpus['npz'], '--steps', '3',
                           '--profile_dir', trace_dir, '--profile_steps',
                           '1', '2'])
  assert len(run.losses) == 3
  assert os.listdir(trace_dir) == ['train_steps_1-2.pt.trace.json']
  with open(os.path.join(trace_dir, 'train_steps_1-2.pt.trace.json')) as f:
    names = {e.get('name', '') for e in json.load(f)['traceEvents']}
  assert any(n.startswith('aten::') for n in names)
  assert 'profiler trace written to' in capsys.readouterr().out


def test_published_stats_directory_feeds_the_cli(corpus, tmp_path):
  """--stats_path <dir> reads DeepMind's NetCDF statistics (the task's
  levels) instead of computing them; the run trains on them."""
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.models import wrappers
  run = train.main(TINY + ['--data', corpus['npz'], '--steps', '2',
                           '--stats_path', corpus['stats']])
  stats = sources.load_stats_netcdf(corpus['stats'],
                                    registry.GENCAST_TASK.pressure_levels)
  stack = next(m for m in run.model.modules()
               if isinstance(m, wrappers.InputsAndResiduals))
  lay = wrappers.find_layout_provider(stack.predictor).input_layout
  np.testing.assert_array_equal(stack.in_scale.numpy(),
                                layout.channel_scales(lay, stats))


def _short_copy(src, dst, frames):
  """A copy of the npz directory `src` holding its first `frames` frames."""
  shutil.copytree(src, dst)
  path = os.path.join(dst, 'era5_202001.npz')
  with np.load(path) as z:
    data = {k: z[k][:frames] for k in z.files}
  np.savez_compressed(path, **data)
  return dst


def test_a_directory_too_short_for_a_window_is_refused(corpus, tmp_path):
  short = _short_copy(corpus['npz'], str(tmp_path / 'short'), 2)
  with pytest.raises(SystemExit, match='2 frames found; a training window .* '
                     'needs 3 consecutive'):
    train.main(TINY + ['--data', short, '--steps', '1'])
  with pytest.raises(SystemExit, match=f'{FRAMES} frames found; a 8-step '
                     r'rollout .* needs 10 consecutive'):
    evaluate.main(['--preset', 'tiny_pallas', '--device', 'cpu', '--data',
                   corpus['npz'], '--max_rollout_steps', '8',
                   '--out_dir', str(tmp_path / 'eval'), '--plot_vars'])


@pytest.mark.parametrize('cpus,want', [(1, 0), (2, 0), (8, 2)])
def test_default_prefetch_is_the_references(cpus, want, monkeypatch):
  monkeypatch.setattr(os, 'cpu_count', lambda: cpus)
  assert train.default_prefetch(None) == want
  assert train.default_prefetch(5) == 5
