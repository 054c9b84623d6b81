"""The port's multi-process entry points on the CPU, each process with its
own timeout (tests/torch_ranks.py): the training CLI's `--dp 2` (two
spawned gloo ranks, one row each) against one process at batch 2, with
rank 0 alone writing metrics and checkpoints and both ranks resuming; the
pod forecast module on two ranks against the one-device ensemble and the
JAX package's `ensemble_scores`, and on two ranks for one member (a model
axis of 2).
"""

import json
import os

import numpy as np
import pytest
import torch

from gencast_tpu.ops import metrics as jax_metrics
from gencast_tpu.parallel import ensemble as jax_ensemble
from gencast_tpu_torch import configs
from gencast_tpu_torch.data import layout
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.parallel import ensemble
from gencast_tpu_torch.scripts import ensemble_forecast_pod as pod
from gencast_tpu_torch.training import checkpoint, train
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# --dp 2 against one process of the same global batch, float32: the
# losses (max relative; the ranks' batch-1 sums and their average round
# otherwise than one batch-2 step) and each parameter's change after the
# steps, relative to its largest change (Adam turns a near-zero
# gradient's float32 noise into a full-size update).
LOSS_RTOL = 1e-5
STEP_RTOL = 2e-2
# The pod's scores (latitude bands, sums across ranks) against ops.metrics
# and JAX's ensemble_scores on the gathered members, max relative.
SCORES_RTOL = 1e-5
# A member computed over a model axis of 2 ranks (partials summed in
# another order) against the one-device member, max relative.
POD_RTOL = 1e-4
TRAIN = 'gencast_tpu_torch.training.train'
ARGV = ['--preset', 'tiny', '--device', 'cpu', '--data', 'synthetic',
        '--batch_size', '2', '--log_every', '1', '--prefetch', '0']


def _losses(path):
  with open(path) as f:
    return [r['loss'] for r in map(json.loads, f) if r['event'] == 'train']


def _params(ckpt, step):
  return list(torch.load(os.path.join(ckpt, f'step_{step}.pt'),
                         weights_only=True)['params'].values())


@pytest.fixture(scope='module')
def dp_runs(tmp_path_factory):
  """One process at batch 2 for 3 steps, then resumed to 4; and the same
  with --dp 2 (with --steps_per_call 2 and a sampling eval, which the
  ranks leave out, as the reference's CLI)."""
  root = tmp_path_factory.mktemp('dp')
  ckpt = {k: str(root / f'ckpt_{k}') for k in ('one', 'dp')}
  metrics = str(root / 'dp.jsonl')
  one = [train.main(ARGV + ['--steps', str(n), '--ckpt_dir', ckpt['one']])
         for n in (3, 4)]
  extra = ['--dp', '2', '--ckpt_dir', ckpt['dp'], '--metrics_jsonl', metrics]
  out = [torch_ranks.run_cli(TRAIN, ARGV + extra + [
      '--steps', '3', '--steps_per_call', '2', '--do_sampling_eval',
      '--eval_every', '1'])]
  out.append(torch_ranks.run_cli(TRAIN, ARGV + extra + ['--steps', '4']))
  return one, out, ckpt, _losses(metrics)


def test_dp2_matches_one_process(dp_runs):
  one, out, ckpt, losses = dp_runs
  assert out[0].count('[train] multihost: process') == 2
  assert 'backend gloo' in out[0] and '[train] mesh: data=2 model=1' in out[0]
  assert out[0].count('packs 1/2 batch rows') == 2
  # Rank 0's metrics hold the averaged loss of each step, once.
  assert len(losses) == 4
  rel = np.abs(np.asarray(losses[:3]) - one[0].losses) / np.abs(
      one[0].losses)
  assert rel.max() <= LOSS_RTOL
  start = [p.detach() for p in configs.build_gencast(
      configs.TINY, seed=0, device='cpu')[0].parameters()]
  for a, b, p0 in zip(_params(ckpt['one'], 2), _params(ckpt['dp'], 2),
                      start):
    moved = a - p0
    assert float((b - p0 - moved).abs().max()) <= STEP_RTOL * float(
        moved.abs().max())


def test_dp2_follows_the_references_rules(dp_runs):
  """Rank 0 alone writes the checkpoints; no sampling eval under
  --multihost; --steps_per_call falls back to per-step dispatch."""
  _, out, ckpt, _ = dp_runs
  assert out[0].count('[train] final checkpoint at') == 1
  assert out[0].count('--do_sampling_eval is disabled under --multihost') == 2
  assert 'sampling eval rmse' not in out[0]
  assert out[0].count('falling back to per-step dispatch') == 2
  assert checkpoint.all_steps(checkpoint.create_manager(ckpt['dp'])) == [2, 3]


def test_dp2_resumes_on_every_rank(dp_runs):
  one, out, ckpt, losses = dp_runs
  assert out[1].count('[train] resumed from step 2') == 2
  assert one[1].start_step == 3
  assert abs(losses[3] - one[1].losses[0]) <= LOSS_RTOL * abs(
      one[1].losses[0])


def test_dp_rules_before_any_rank_starts():
  """The reference's rules for several ranks, checked before they start."""
  with pytest.raises(SystemExit, match='must be divisible by dp'):
    train.main(['--preset', 'tiny', '--device', 'cpu', '--batch_size', '3',
                '--dp', '2'])
  with pytest.raises(SystemExit, match='--ar_steps > 1 is not supported'):
    train.main(['--preset', 'tiny', '--device', 'cpu', '--model',
                'graphcast', '--ar_steps', '2', '--dp', '2', '--batch_size',
                '2'])


def test_pod_forecast_on_two_ranks(tmp_path):
  """The pod module's members (3 over an ensemble axis of 2, as the
  reference's pod: padded to 4, run in chunks of 2 with one member per
  rank and call, so members 0 and 2 on rank 0 and 1 on rank 1, the padded
  member 3 discarded) are bitwise the one-device ensemble_rollout's; its
  scores, reduced over the ranks, match ops.metrics and JAX's
  ensemble_scores on those members."""
  out = str(tmp_path / 'forecast.npz')
  argv = ['--preset', 'tiny', '--device', 'cpu', '--members', '3',
          '--steps', '2', '--score', '--out', out]
  stdout = torch_ranks.run_cli('gencast_tpu_torch.scripts.'
                               'ensemble_forecast_pod',
                               argv + ['--num_processes', '2'])
  assert 'mesh ensemble=2 model=1' in stdout
  got = {}
  for rank, ids in ((0, [0, 2]), (1, [1])):
    z = np.load(str(tmp_path / f'forecast.p{rank}.npz'))
    assert z['members'].tolist() == ids
    got.update(zip(ids, z['predictions']))
  args = pod.parse_args(argv)
  wrapped, statics, (inputs, forcings, targets) = pod.build_forecast(
      args, torch.device('cpu'))
  want = ensemble.ensemble_rollout(wrapped, inputs, forcings, seed=0,
                                   num_members=3).numpy()
  for m in range(3):
    np.testing.assert_array_equal(got[m], want[m])
  with open(str(tmp_path / 'forecast.scores.json')) as f:
    scores = json.load(f)['scores']
  lat_w = layout.latitude_weights(np.asarray(statics.grid_lat))
  target = wrappers.find_layout_provider(wrapped).target_layout
  jax_scores = jax_ensemble.ensemble_scores(want, targets.numpy(), lat_w)
  port = ensemble.ensemble_scores(torch.as_tensor(want), targets,
                                  torch.as_tensor(lat_w))
  for name in ('crps', 'rmse', 'spread'):
    for ref in (jax_scores[name], port[name]):
      ref = jax_metrics.per_variable(np.asarray(ref), target)
      for var, v in ref.items():
        w, s = np.asarray(v)[:, 0], np.asarray(scores[name][var])
        assert np.abs(s - w).max() <= SCORES_RTOL * np.abs(w).max(), (name,
                                                                      var)


def test_pod_refuses_a_model_factor(tmp_path):
  """2 ranks for 1 member leave a model factor of 2, once refused and now
  the model axis: the two ranks compute the member together (heads and
  MLP hidden widths split), one of them saves it, within POD_RTOL of the
  one-device member."""
  out = str(tmp_path / 'forecast.npz')
  argv = ['--preset', 'tiny', '--device', 'cpu', '--members', '1',
          '--steps', '1', '--out', out]
  stdout = torch_ranks.run_cli('gencast_tpu_torch.scripts.'
                               'ensemble_forecast_pod',
                               argv + ['--num_processes', '2'])
  assert stdout.count('mesh ensemble=1 model=2') == 2
  assert sorted(os.listdir(tmp_path)) == ['forecast.p0.npz']
  got = np.load(str(tmp_path / 'forecast.p0.npz'))['predictions']
  wrapped, _, (inputs, forcings, _) = pod.build_forecast(
      pod.parse_args(argv), torch.device('cpu'))
  want = ensemble.ensemble_rollout(wrapped, inputs, forcings, seed=0,
                                   num_members=1).numpy()
  assert np.abs(got - want).max() <= POD_RTOL * np.abs(want).max()
  assert pod.ensemble_axis(64, 50) == 32 and pod.ensemble_axis(4, 50) == 4
