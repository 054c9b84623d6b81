"""The training and evaluate CLIs with `--model graphcast` on the CPU, at
the TINY preset (GraphCast's variables at TINY's grid, mesh and widths).

A run takes two steps with a checkpoint, resumes it with the two-step
autoregressive loss (`--ar_steps 2`), and the fused path
(`--steps_per_call 2`) gives the per-step AR loop's bits; an npz corpus of
the port's `tools.synth_era5` trains and evaluates through the same
flags; a source too short for K target frames is refused with a message.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from gencast_tpu_torch import configs
from gencast_tpu_torch.data import registry, sources
from gencast_tpu_torch.models import graphcast
from gencast_tpu_torch.tools import synth_era5
from gencast_tpu_torch.training import evaluate, train
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = ['--model', 'graphcast', '--preset', 'tiny', '--device', 'cpu',
        '--log_every', '1', '--prefetch', '0']


def _params(model):
  return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope='module')
def ckpt_runs(tmp_path_factory):
  ckpt = str(tmp_path_factory.mktemp('gc_ckpt'))
  first = train.main(TINY + ['--steps', '2', '--ckpt_dir', ckpt])
  resumed = train.main(TINY + ['--steps', '4', '--ar_steps', '2',
                               '--ckpt_dir', ckpt])
  return ckpt, first, resumed


def test_train_graphcast_then_ar_resume(ckpt_runs):
  ckpt, first, resumed = ckpt_runs
  assert isinstance(first.model.predictor, graphcast.GraphCast)
  assert len(first.losses) == 2 and np.isfinite(first.losses).all()
  assert resumed.start_step == 2 and len(resumed.losses) == 2
  assert np.isfinite(resumed.losses).all()
  assert os.path.exists(os.path.join(ckpt, 'step_3.pt'))


def test_fused_ar_steps_equal_the_per_step_loop():
  """--steps_per_call 2 with --ar_steps 2 (two replays of one graph per
  call on the card, eager here) gives the per-step AR loop's losses and
  parameters bit for bit: the same windows in the same order."""
  argv = TINY + ['--steps', '4', '--ar_steps', '2', '--seed', '3']
  loop = train.main(argv)
  fused = train.main(argv + ['--steps_per_call', '2'])
  assert loop.losses == fused.losses
  want, got = _params(loop.model), _params(fused.model)
  assert all(torch.equal(want[n], got[n]) for n in want)


def test_evaluate_graphcast_from_the_checkpoint(ckpt_runs, tmp_path):
  """One deterministic forecast, its per-variable RMSE; --chunk_size gives
  the same forecast."""
  ckpt, _, resumed = ckpt_runs
  base = ['--model', 'graphcast', '--preset', 'tiny', '--device', 'cpu',
          '--ckpt_dir', ckpt, '--max_rollout_steps', '3', '--plot_vars']
  run = evaluate.main(base + ['--out_dir', str(tmp_path / 'a')])
  chunked = evaluate.main(base + ['--out_dir', str(tmp_path / 'b'),
                                  '--chunk_size', '2'])
  assert run.predictions.shape[:2] == (1, 3)
  assert np.isfinite(run.predictions).all()
  np.testing.assert_array_equal(run.predictions, chunked.predictions)
  with open(tmp_path / 'a' / 'metrics.json') as f:
    metrics = json.load(f)
  assert metrics['members'] == 1 and metrics['steps'] == 3
  layout = run.model.predictor.target_layout
  assert sorted(metrics['rmse']) == sorted(layout.var_names)
  # The restored parameters are the checkpoint's.
  for n, p in _params(resumed.model).items():
    assert torch.equal(dict(run.model.named_parameters())[n], p), n


@pytest.fixture(scope='module')
def npz_corpus(tmp_path_factory):
  """Six 12-hourly frames at 10 degrees in the npz layout. ERA5 corpora
  carry the 12-hour precipitation; GraphCast's variables hold the 6-hour
  one, which a 6-hourly conversion would write: it is added to each shard
  here."""
  path = str(tmp_path_factory.mktemp('gc_npz'))
  synth_era5.synthesize(path, resolution_deg=10.0, steps_per_month=6,
                        seed=4, layout='npz')
  for shard in glob.glob(os.path.join(path, 'era5_*.npz')):
    with np.load(shard) as z:
      data = dict(z)
    data['total_precipitation_6hr'] = data['total_precipitation_12hr'] / 2
    np.savez(shard, **data)
  return path


def test_npz_corpus_trains_and_evaluates_graphcast(npz_corpus, tmp_path):
  task = dataclasses.replace(registry.GRAPHCAST_TASK_13,
                             pressure_levels=configs.TINY.task.pressure_levels)
  assert len(sources.Era5NpzSource(npz_corpus, task)) == 4
  ckpt = str(tmp_path / 'ckpt')
  run = train.main(TINY + ['--data', npz_corpus, '--steps', '2',
                           '--ar_steps', '2', '--ckpt_dir', ckpt])
  assert len(run.losses) == 2 and np.isfinite(run.losses).all()
  ev = evaluate.main(['--model', 'graphcast', '--preset', 'tiny', '--device',
                      'cpu', '--data', npz_corpus, '--ckpt_dir', ckpt,
                      '--max_rollout_steps', '2', '--plot_vars',
                      '--out_dir', str(tmp_path / 'eval')])
  assert ev.predictions.shape[:2] == (1, 2)
  assert np.isfinite(ev.predictions).all()


def test_a_source_too_short_for_the_ar_window_is_refused(npz_corpus):
  """Four windows hold at most four target frames: --ar_steps 5 exits with
  a message, before a pool or an iterator is built (the reference raises
  an IndexError from inside its pool)."""
  with pytest.raises(SystemExit, match='too short for --ar_steps 5'):
    train.main(TINY + ['--data', npz_corpus, '--steps', '1',
                       '--ar_steps', '5'])
  with pytest.raises(SystemExit, match='too short for --ar_steps 5'):
    train.main(TINY + ['--data', npz_corpus, '--steps', '2',
                       '--ar_steps', '5', '--steps_per_call', '2'])


@pytest.mark.parametrize('cli', ['train', 'evaluate'])
def test_graphcast_needs_the_card_unless_told(cli, monkeypatch):
  """Both CLIs run GraphCast on the card by default: without one they raise
  before building anything, and never carry on on the CPU."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  main = train.main if cli == 'train' else evaluate.main
  with pytest.raises(RuntimeError, match='no CUDA card'):
    main(['--model', 'graphcast', '--preset', '1deg'])
