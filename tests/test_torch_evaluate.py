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
  train.main(['--preset', 'tiny', '--data', 'synthetic', '--device', 'cpu',
              '--steps', '2', '--ckpt_dir', ckpt])
  run = evaluate.main(['--preset', 'tiny', '--device', 'cpu', '--ckpt_dir',
                       ckpt, '--num_members', str(MEMBERS),
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
    (['--chunk_size', '2'], '0.25 degree'),
    (['--attention_type', 'dense'], 'other attention backends'),
    (['--no_overlap_offload'], '0.25 degree'),
    (['--save_netcdf'], 'CLIs and data'),
    (['--model', 'graphcast'], 'GraphCast'),
])
def test_evaluate_refuses_what_is_not_ported(argv, match, capsys):
  with pytest.raises(SystemExit):
    evaluate.parse_args(['--preset', 'tiny'] + argv)
  assert match in capsys.readouterr().err


@pytest.mark.parametrize('member_chunk', [1, 2])
def test_evaluate_member_chunk_gives_the_same_predictions(evaluated,
                                                          member_chunk,
                                                          tmp_path):
  """--member_chunk groups the members on their way to the host and changes
  nothing in what they forecast."""
  run, ckpt, _ = evaluated
  chunked = evaluate.main(['--preset', 'tiny', '--device', 'cpu', '--ckpt_dir',
                           ckpt, '--num_members', str(MEMBERS),
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
  train.main(['--preset', 'tiny', '--data', 'synthetic', '--device', 'cpu',
              '--steps', '2', '--do_sampling_eval', '--eval_every', '2',
              '--metrics_jsonl', str(jsonl)])
  with open(jsonl) as f:
    events = [json.loads(line) for line in f]
  evals = [e for e in events if e['event'] == 'sampling_eval']
  assert [e['step'] for e in evals] == [2, 2]
  assert np.isfinite(evals[0]['rmse'])
  assert os.path.exists(evals[1]['path'])
  assert os.path.dirname(evals[1]['path']) == str(tmp_path)
