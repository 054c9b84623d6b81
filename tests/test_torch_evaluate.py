"""The port's evaluate CLI on a checkpoint its train CLI wrote, on CPU at the
TINY preset: the reference CLI's metrics.json keys and rollout.npz layout,
the restored parameters, and the RMSE against the reference's function.
"""

import json
import os

import numpy as np
import pytest
import torch

from gencast_tpu.training import evaluate as jax_evaluate
from gencast_tpu_torch.data import layout, registry
from gencast_tpu_torch.training import evaluate, train
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MEMBERS, STEPS = 2, 2


@pytest.fixture(scope='module')
def evaluated(tmp_path_factory):
  root = tmp_path_factory.mktemp('eval')
  ckpt, out = str(root / 'ckpt'), str(root / 'out')
  train.main(['--preset', 'tiny_pallas', '--data', 'synthetic', '--device',
              'cpu', '--steps', '2', '--ckpt_dir', ckpt])
  run = evaluate.main(['--preset', 'tiny_pallas', '--device', 'cpu',
                       '--ckpt_dir', ckpt, '--num_members', str(MEMBERS),
                       '--max_rollout_steps', str(STEPS), '--out_dir', out,
                       '--plot_vars'])
  return run, ckpt, out


def test_evaluate_writes_the_reference_outputs(evaluated):
  run, _, out = evaluated
  with open(os.path.join(out, 'metrics.json')) as f:
    scores = json.load(f)
  # The keys of the reference CLI's metrics.json (its evaluate.main: rmse,
  # steps, members; crps and spread with more than one member).
  assert scores.keys() == {'rmse', 'steps', 'members', 'crps', 'spread'}
  assert (scores['steps'], scores['members']) == (STEPS, MEMBERS)
  task = registry.GENCAST_TASK
  target = layout.build_layout(task.target_variables, task.pressure_levels, 1)
  for key in ('rmse', 'crps', 'spread'):
    assert list(scores[key]) == list(target.var_names)
    assert np.isfinite(list(scores[key].values())).all()
  z = np.load(os.path.join(out, 'rollout.npz'))
  assert sorted(z.files) == ['lat', 'lon', 'predictions', 'truth']
  assert z['predictions'].shape == (MEMBERS, STEPS, 19, 36,
                                    target.num_channels)
  assert z['truth'].shape == z['predictions'].shape[1:]
  np.testing.assert_array_equal(z['predictions'], run.predictions)
  want = jax_evaluate.per_variable_rmse(z['predictions'].mean(axis=0),
                                        z['truth'], target)
  assert scores['rmse'] == pytest.approx(want, rel=1e-6)


def test_evaluate_restores_the_checkpoint(evaluated):
  run, ckpt, _ = evaluated
  state = torch.load(os.path.join(ckpt, 'step_1.pt'), weights_only=True)
  params = dict(run.model.named_parameters())
  assert params.keys() == state['params'].keys()
  for name, p in params.items():
    assert torch.equal(p, state['params'][name]), name


@pytest.mark.parametrize('argv,match', [
    # The reference's einsum 'dense' attention, refused until it was ported,
    # evaluates a checkpoint of a dense model (match None).
    pytest.param(['--attention_type', 'dense'], None,
                 id='argv0-other attention backends'),
    # GraphCast, refused until it was ported, parses (match None).
    pytest.param(['--model', 'graphcast'], None, id='argv1-GraphCast'),
])
def test_evaluate_refuses_what_is_not_ported(argv, match, capsys, tmp_path):
  if match is None and '--model' in argv:
    args = evaluate.parse_args(['--preset', 'tiny'] + argv)
    assert args.model == 'graphcast'
    return
  if match is None:
    ckpt = str(tmp_path / 'ckpt')
    train.main(['--preset', 'tiny', '--data', 'synthetic', '--device', 'cpu',
                '--steps', '2', '--ckpt_dir', ckpt] + argv)
    run = evaluate.main(['--preset', 'tiny', '--device', 'cpu', '--ckpt_dir',
                         ckpt, '--num_members', '2', '--max_rollout_steps',
                         '1', '--out_dir', str(tmp_path / 'out'),
                         '--plot_vars'] + argv)
    out = capsys.readouterr().out
    assert 'attention=dense' in out and 'restored checkpoint step 1' in out
    assert np.isfinite(run.predictions).all()
    assert np.isfinite(list(run.results['crps'].values())).all()
    return
  with pytest.raises(SystemExit):
    evaluate.parse_args(['--preset', 'tiny'] + argv)
  assert match in capsys.readouterr().err


@pytest.mark.parametrize('h5py_present', [True, False])
def test_evaluate_save_netcdf(evaluated, h5py_present, tmp_path, monkeypatch,
                              capsys):
  """--save_netcdf, refused until the ERA5 data path was ported, writes
  rollout.nc (the ensemble mean and the truth, read back with h5py); where
  h5py is missing it says so and skips, as the reference's CLI does, and
  the rest of the outputs are written."""
  import sys
  h5py = pytest.importorskip('h5py')
  run, ckpt, _ = evaluated
  if not h5py_present:
    monkeypatch.setitem(sys.modules, 'h5py', None)
  again = evaluate.main(['--preset', 'tiny_pallas', '--device', 'cpu',
                         '--ckpt_dir', ckpt, '--num_members', str(MEMBERS),
                         '--max_rollout_steps', str(STEPS), '--out_dir',
                         str(tmp_path), '--plot_vars', '--save_netcdf'])
  np.testing.assert_array_equal(again.predictions, run.predictions)
  path = os.path.join(str(tmp_path), 'rollout.nc')
  out = capsys.readouterr().out
  if not h5py_present:
    assert '--save_netcdf skipped' in out and not os.path.exists(path)
    assert os.path.exists(os.path.join(str(tmp_path), 'rollout.npz'))
    return
  assert f'NetCDF rollout written to {path}' in out
  task = registry.GENCAST_TASK
  target = layout.build_layout(task.target_variables, task.pressure_levels, 1)
  ch = target.var_channels('2m_temperature')[0]
  with h5py.File(path, 'r') as f, \
      np.load(os.path.join(str(tmp_path), 'rollout.npz')) as z:
    np.testing.assert_array_equal(f['2m_temperature'][...],
                                  run.predictions.mean(axis=0)[..., ch])
    np.testing.assert_array_equal(f['target_2m_temperature'][...],
                                  z['truth'][..., ch])


@pytest.mark.parametrize('argv,overlap', [
    (['--chunk_size', '1'], True),
    (['--chunk_size', '1', '--no_overlap_offload'], False),
])
def test_evaluate_takes_the_chunked_rollout_options(evaluated, argv, overlap,
                                                    tmp_path, monkeypatch):
  """--chunk_size (and --no_overlap_offload), refused until the 0.25-degree
  slice, parse and reach the rollout: each member's steps go through
  rollout.chunked_rollout, with the offload the flags ask for, and the
  predictions and scores are the unchunked run's."""
  from gencast_tpu_torch import rollout
  run, ckpt, _ = evaluated
  args = evaluate.parse_args(['--preset', 'tiny'] + argv)
  assert (args.chunk_size, args.no_overlap_offload) == (1, not overlap)
  seen = []
  chunked = rollout.chunked_rollout

  def spy(*a, **kwargs):
    seen.append((kwargs['chunk_size'], kwargs['overlap_offload']))
    return chunked(*a, **kwargs)

  monkeypatch.setattr(rollout, 'chunked_rollout', spy)
  again = evaluate.main(['--preset', 'tiny_pallas', '--device', 'cpu',
                         '--ckpt_dir', ckpt, '--num_members', str(MEMBERS),
                         '--max_rollout_steps', str(STEPS), '--out_dir',
                         str(tmp_path), '--plot_vars'] + argv)
  assert seen == [(1, overlap)] * MEMBERS
  np.testing.assert_array_equal(again.predictions, run.predictions)
  assert again.results == run.results
  with pytest.raises(SystemExit):
    evaluate.parse_args(['--preset', 'tiny', '--chunk_size', '0'])


@pytest.mark.parametrize('member_chunk', [1, 2])
def test_evaluate_member_chunk_gives_the_same_predictions(evaluated,
                                                          member_chunk,
                                                          tmp_path):
  """--member_chunk groups the members on their way to the host and changes
  nothing in what they forecast."""
  run, ckpt, _ = evaluated
  chunked = evaluate.main(['--preset', 'tiny_pallas', '--device', 'cpu',
                           '--ckpt_dir', ckpt, '--num_members', str(MEMBERS),
                           '--max_rollout_steps', str(STEPS), '--out_dir',
                           str(tmp_path), '--plot_vars', '--member_chunk',
                           str(member_chunk)])
  np.testing.assert_array_equal(chunked.predictions, run.predictions)
  assert chunked.results == run.results


def test_evaluate_needs_the_card_unless_told(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA card'):
    evaluate.main(['--preset', 'tiny', '--plot_vars'])


def test_train_cli_sampling_eval_logs_rmse_and_triptych(tmp_path):
  """--do_sampling_eval samples one forecast every --eval_every steps; with
  a metrics file it also writes the triptych image beside it, as the
  reference's CLI."""
  jsonl = tmp_path / 'metrics.jsonl'
  train.main(['--preset', 'tiny_pallas', '--data', 'synthetic', '--device',
              'cpu', '--steps', '2', '--do_sampling_eval', '--eval_every', '2',
              '--metrics_jsonl', str(jsonl)])
  with open(jsonl) as f:
    events = [json.loads(line) for line in f]
  evals = [e for e in events if e['event'] == 'sampling_eval']
  assert [e['step'] for e in evals] == [2, 2]
  assert np.isfinite(evals[0]['rmse'])
  assert os.path.exists(evals[1]['path'])
  assert os.path.dirname(evals[1]['path']) == str(tmp_path)
