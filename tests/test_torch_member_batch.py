"""Ensemble members as one batch (`gencast_tpu_torch.parallel.ensemble`,
`rollout.sample_rollout` and `GenCast.sample` given `generators` or noise
per member) against the JAX package's vmapped ensemble
(`gencast_tpu.parallel.ensemble`), and against the members' own
one-member runs, on CPU.

The JAX side gives member m the key fold_in(key, m) and samples all
members in one vmapped program; here each member's draws are made on the
JAX side from that key and injected into the port, on the tri-block TINY
model of tests/test_torch_rollout.py (two 12-hour steps of 3 denoiser
calls). Where the port draws from its own generators (make_ensemble_rollout,
ensemble_sample), the model's one drawing function, `sphere_noise`, hands
out each member's JAX fields in order.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.parallel import ensemble as jax_ensemble
from gencast_tpu_torch import rollout
from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.models import gencast as gencast_lib
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.models.gencast import GenCast
from gencast_tpu_torch.nn import mlp
from gencast_tpu_torch.ops import metrics
from gencast_tpu_torch.parallel import ensemble
from gencast_tpu_torch.scripts import ensemble_forecast_pod as pod
from gencast_tpu_torch.training import evaluate
from tests import torch_ranks
from tests.test_torch_rollout import (SAMPLE_RTOL, SPEC, STEPS, _jax_draws,
                                      models)  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MEMBERS = 3
# The pod's scores on two ranks (latitude bands summed over the ranks)
# against ops.metrics on the one-device members: float32 sums in another
# order (tests/test_torch_multihost.py's SCORES_RTOL).
SCORES_RTOL = 1e-5


def _rel(got, want) -> float:
  return float(np.abs(got - want).max() / np.abs(want).max())


def _call_draws(jmodel, key):
  """One sample call's N + 1 noise fields as the JAX sampler draws them
  from `key`: x0's from the first split, then one per churn step from
  split(rest, N) (models/gencast.py sample)."""
  rest, k0 = jax.random.split(key)
  keys = [k0] + list(jax.random.split(rest, SPEC.num_noise_levels))
  return [torch.as_tensor(np.array(jmodel._sphere_noise(k, 1, jnp.float32)))
          for k in keys]


def _gencast(stack) -> GenCast:
  return next(m for m in stack.modules() if isinstance(m, GenCast))


def _serve_jax_fields(monkeypatch, stack, fields_by_member):
  """Makes the port's member m, keyed (seed, m), draw `fields_by_member[m]`
  in order: `keyed_generator` tags each generator with its member, and the
  model's `sphere_noise` hands out that member's next field."""
  streams, owner = {}, {}
  keyed = ensemble.diffusion_utils.keyed_generator

  def tagged(seed, m, device='cpu'):
    gen = keyed(seed, m, device=device)
    owner[id(gen)] = m
    streams.setdefault(m, iter(fields_by_member[m]))
    return gen

  def draw(generator, batch, dtype=torch.float32):
    field = next(streams[owner[id(generator)]])
    assert field.shape[0] == batch
    return field.to(dtype)

  monkeypatch.setattr(ensemble.diffusion_utils, 'keyed_generator', tagged)
  monkeypatch.setattr(_gencast(stack), 'sphere_noise', draw)


def _truth(tstack, data):
  rng = np.random.default_rng(4)
  return rng.standard_normal(
      (STEPS,) + data['inputs'].shape[:3]
      + (tstack.predictor.target_layout.num_channels,)).astype(np.float32)


@pytest.mark.parametrize('teacher', [False, True])
def test_batched_ensemble_rollout_matches_jax_vmapped(models, teacher):
  jmodel, jstack, tstack, data = models
  truth = _truth(tstack, data)
  key = jax.random.PRNGKey(31)
  keys = jax_ensemble.member_keys(key, MEMBERS)
  want = np.asarray(jax_ensemble.ensemble_rollout(
      jstack, jnp.asarray(data['inputs']), jnp.asarray(data['forcings']),
      key, MEMBERS, teacher_targets=jnp.asarray(truth) if teacher else None))
  got = ensemble.ensemble_rollout(
      tstack, torch.as_tensor(data['inputs']),
      torch.as_tensor(data['forcings']),
      noise=[_jax_draws(jmodel, k) for k in keys],
      teacher_targets=torch.as_tensor(truth) if teacher else None).numpy()
  assert got.shape == want.shape == (MEMBERS, STEPS) + truth.shape[1:]
  assert _rel(got, want) <= SAMPLE_RTOL
  assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize('teacher', [False, True])
def test_make_ensemble_rollout_matches_jax_vmapped(models, teacher,
                                                   monkeypatch):
  """The port's member-chunk callable (one batch of the chunk's members,
  each from its (seed, m) generator) against the JAX package's, over the
  same members' draws."""
  jmodel, jstack, tstack, data = models
  truth = _truth(tstack, data)
  keys = jax_ensemble.member_keys(jax.random.PRNGKey(32), MEMBERS)
  teacher_t = jnp.asarray(truth) if teacher else None
  want = np.asarray(jax_ensemble.make_ensemble_rollout(
      jstack, teacher_targets=teacher_t)(
          jnp.asarray(data['inputs']), jnp.asarray(data['forcings']), keys))
  _serve_jax_fields(monkeypatch, tstack, [
      list(itertools.chain.from_iterable(_jax_draws(jmodel, k)))
      for k in keys])
  run = ensemble.make_ensemble_rollout(
      tstack, teacher_targets=torch.as_tensor(truth) if teacher else None)
  got = run(torch.as_tensor(data['inputs']),
            torch.as_tensor(data['forcings']), 0, range(MEMBERS)).numpy()
  assert got.shape == want.shape == (MEMBERS, STEPS) + truth.shape[1:]
  assert _rel(got, want) <= SAMPLE_RTOL


def test_ensemble_sample_matches_jax_vmapped(models, monkeypatch):
  jmodel, jstack, tstack, data = models
  key = jax.random.PRNGKey(33)
  want = np.asarray(jax_ensemble.ensemble_sample(
      jstack, jnp.asarray(data['inputs']), jnp.asarray(data['forcings'][0]),
      key, MEMBERS))
  _serve_jax_fields(monkeypatch, tstack, [
      _call_draws(jmodel, k)
      for k in jax_ensemble.member_keys(key, MEMBERS)])
  got = ensemble.ensemble_sample(tstack, torch.as_tensor(data['inputs']),
                                 torch.as_tensor(data['forcings'][0]), 0,
                                 MEMBERS).numpy()
  assert got.shape == want.shape == (MEMBERS,) + data['inputs'].shape[:3] + (
      tstack.predictor.target_layout.num_channels,)
  assert _rel(got, want) <= SAMPLE_RTOL
  assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize('member_chunk', [None, 1, 2, 3])
def test_batched_members_are_their_own_runs(models, member_chunk):
  """However the 3 members are grouped into batches (all at once, 1, 2
  with a short last group, 3), each member's forecast is bitwise its own
  one-member rollout from its (seed, m) generator."""
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(data['forcings'])
  own = torch.stack([rollout.sample_rollout(tstack, inputs, forcings, key)
                     for key in ensemble.member_keys(7, MEMBERS)])
  got = ensemble.ensemble_rollout(tstack, inputs, forcings, seed=7,
                                  num_members=MEMBERS,
                                  member_chunk=member_chunk)
  assert got.device.type == 'cpu' and torch.equal(got, own)
  assert not torch.equal(got[0], got[1])


def test_sample_rollout_members_return_their_windows(models):
  """Given per-member generators, sample_rollout returns [M, K, B, ...]
  and the final windows [M, B, ...], each member's bitwise its own
  rollout's; teacher forcing advances every member's window alike."""
  _, _, tstack, data = models
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(data['forcings'])
  truth = torch.as_tensor(_truth(tstack, data))
  preds, windows = rollout.sample_rollout(
      tstack, inputs, forcings, generators=ensemble.member_keys(8, 2),
      teacher_targets=truth, return_final_inputs=True)
  assert preds.shape[:3] == (2, STEPS, 1) and windows.shape[:2] == (2, 1)
  for m, key in enumerate(ensemble.member_keys(8, 2)):
    want, window = rollout.sample_rollout(
        tstack, inputs, forcings, key, teacher_targets=truth,
        return_final_inputs=True)
    assert torch.equal(preds[m], want) and torch.equal(windows[m], window)
  # Teacher-forced windows end on the truth, whatever a member predicted.
  assert torch.equal(windows[0], windows[1])


@pytest.mark.parametrize('rows', [1, 2])
def test_gencast_sample_with_generators(models, rows):
  """GenCast.sample over M members of `rows` rows each, one generator per
  member: member m's rows are bitwise that member's own call."""
  _, _, tstack, _ = models
  model = _gencast(tstack)
  d = model.denoiser
  rng = np.random.default_rng(11)
  grid = (rows, d.num_lat, d.num_lon)
  inputs = torch.as_tensor(rng.standard_normal(
      grid + (d.input_layout.num_channels,)).astype(np.float32))
  forcings = torch.as_tensor(rng.standard_normal(
      grid + (d.forcing_layout.num_channels,)).astype(np.float32))
  got = model.sample(torch.cat([inputs] * MEMBERS),
                     torch.cat([forcings] * MEMBERS),
                     generators=ensemble.member_keys(12, MEMBERS))
  assert got.shape == (MEMBERS * rows,) + grid[1:] + (
      d.target_layout.num_channels,)
  for m, key in enumerate(ensemble.member_keys(12, MEMBERS)):
    own = model.sample(inputs, forcings, key)
    assert torch.equal(got[m * rows:(m + 1) * rows], own), m


def test_gencast_sample_with_noise_per_member(models):
  """Noise given per member equals the same fields drawn by the members'
  generators (the draws are the only difference between the two)."""
  _, _, tstack, data = models
  model = _gencast(tstack)
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(data['forcings'][0])
  fields = [[model.sphere_noise(key, 1)
             for _ in range(SPEC.num_noise_levels + 1)]
            for key in ensemble.member_keys(13, 2)]
  by_noise = model.sample(torch.cat([inputs] * 2), torch.cat([forcings] * 2),
                          noise=fields)
  by_keys = model.sample(torch.cat([inputs] * 2), torch.cat([forcings] * 2),
                         generators=ensemble.member_keys(13, 2))
  assert torch.equal(by_noise, by_keys)


def test_member_draws_are_checked(models):
  _, _, tstack, data = models
  model = _gencast(tstack)
  inputs = torch.as_tensor(data['inputs'])
  forcings = torch.as_tensor(data['forcings'])
  keys = ensemble.member_keys(1, 2)
  with pytest.raises(ValueError, match='exactly one of them'):
    model.sample(inputs, forcings[0], keys[0], generators=keys)
  with pytest.raises(ValueError, match='2 members for a batch of 1 rows'):
    model.sample(inputs, forcings[0], generators=keys)
  with pytest.raises(TypeError, match='generators='):
    rollout.chunked_rollout(tstack, inputs, forcings, keys, chunk_size=1)
  with pytest.raises(ValueError, match='noise for 1 steps'):
    rollout.sample_rollout(tstack, inputs, forcings, noise=[
        [[torch.zeros(1)]], [[torch.zeros(1)]]])


@pytest.mark.parametrize('depth,nested,one', [(1, 1, True), (1, 2, False),
                                              (2, 2, True), (2, 3, False)])
def test_member_draws_by_nesting(depth, nested, one):
  """Noise nested `depth` lists deep is one member's (a batch of one);
  one list deeper, one entry per member. A generator is one member's;
  `generators` one per member."""
  field = torch.zeros(1)
  noise = field
  for _ in range(nested):
    noise = [noise, noise]
  gens, got, got_one = gencast_lib.member_draws(None, None, noise, depth)
  assert gens is None and got_one is one
  assert len(got) == (1 if one else 2) and got[0] is (noise if one
                                                      else noise[0])
  key = torch.Generator()
  assert gencast_lib.member_draws(key, None, None, depth) == ([key], None,
                                                              True)
  assert gencast_lib.member_draws(None, (key, key), None, depth) == (
      [key, key], None, False)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rowwise_linear_rows_do_not_depend_on_the_batch(dtype):
  """The conditioning path's product (noise encoder, FiLM projections):
  each row of a B-row call is bitwise the same row alone, at every B (a
  plain GEMM of a few rows picks its kernel by the row count)."""
  lin = mlp.RowwiseLinear(16, 1024,
                          rng=torch.Generator().manual_seed(0)).to(dtype)
  with torch.no_grad():
    lin.bias.normal_(generator=torch.Generator().manual_seed(1))
  x = torch.randn(50, 16, generator=torch.Generator().manual_seed(2)).to(dtype)
  alone = [lin(x[r:r + 1]) for r in range(x.shape[0])]
  for rows in (2, 3, 8, 50):
    got = lin(x[:rows])
    for r in range(rows):
      assert torch.equal(got[r:r + 1], alone[r]), (rows, r)
  np.testing.assert_allclose(
      lin(x[:8]).float().detach().numpy(),
      torch.nn.functional.linear(x[:8], lin.weight, lin.bias).float()
      .detach().numpy(), rtol=1e-2 if dtype == torch.bfloat16 else 1e-5,
      atol=1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.fixture(scope='module')
def evaluated_modes(tmp_path_factory):
  """The evaluate CLI on TINY_PALLAS's untrained weights, 3 members x 2
  steps, in the reference's three modes."""
  root = tmp_path_factory.mktemp('modes')
  base = ['--preset', 'tiny_pallas', '--device', 'cpu', '--num_members',
          str(MEMBERS), '--max_rollout_steps', '2', '--plot_vars']
  return {name: evaluate.main(base + flags + ['--out_dir',
                                              str(root / name)])
          for name, flags in (('batch', []),
                              ('member_chunk', ['--member_chunk', '2']),
                              ('chunk_size', ['--chunk_size', '1']))}


@pytest.mark.parametrize('mode', ['member_chunk', 'chunk_size'])
def test_evaluate_modes_give_the_same_predictions(evaluated_modes, mode):
  """No flag (all members as one batch), --member_chunk 2 (batches of 2
  and 1) and --chunk_size 1 (each member alone, a step at a time) give
  bitwise the same predictions and scores."""
  want = evaluated_modes['batch']
  got = evaluated_modes[mode]
  assert want.predictions.shape[:2] == (MEMBERS, 2)
  np.testing.assert_array_equal(got.predictions, want.predictions)
  assert got.results == want.results
  assert not np.array_equal(want.predictions[0], want.predictions[1])


def test_evaluate_refuses_a_member_chunk_below_one():
  with pytest.raises(SystemExit):
    evaluate.parse_args(['--preset', 'tiny', '--member_chunk', '0'])


def test_pod_pads_three_members_over_two_ranks(tmp_path):
  """3 members over an ensemble axis of 2, as the reference's pod: padded
  to 4, two calls of one member per rank, member 3 (rank 1's second call)
  discarded; the scores on the devices are those of the 3 members alone
  (ops.metrics on the one-device ensemble), so the padding reached none."""
  out = str(tmp_path / 'forecast.npz')
  argv = ['--preset', 'tiny', '--device', 'cpu', '--members', '3',
          '--steps', '1', '--score', '--no-save_members', '--out', out]
  stdout = torch_ranks.run_cli('gencast_tpu_torch.scripts.'
                               'ensemble_forecast_pod',
                               argv + ['--num_processes', '2'])
  assert 'rank 0: members [0, 2] x 1 steps' in stdout
  assert 'rank 1: members [1] x 1 steps' in stdout
  assert stdout.count('2 calls of one member') == 2
  assert '2 calls of one member, 1 of them padding' in stdout
  assert sorted(p.name for p in tmp_path.iterdir()) == [
      'forecast.scores.json']
  args = pod.parse_args(argv)
  wrapped, statics, (inputs, forcings, targets) = pod.build_forecast(
      args, torch.device('cpu'))
  members = ensemble.ensemble_rollout(wrapped, inputs, forcings, seed=0,
                                      num_members=3)
  lat_w = torch.as_tensor(layout_lib.latitude_weights(
      np.asarray(statics.grid_lat)))
  target = wrappers.find_layout_provider(wrapped).target_layout
  reference = {'crps': metrics.crps_ensemble(members, targets, lat_w),
               'rmse': metrics.ensemble_mean_rmse(members, targets, lat_w),
               'spread': metrics.ensemble_spread(members, lat_w)}
  with open(str(tmp_path / 'forecast.scores.json')) as f:
    scores = json.load(f)
  assert scores['members'] == 3
  for name, arr in reference.items():
    for var, v in metrics.per_variable(arr, target).items():
      w, s = np.asarray(v)[:, 0], np.asarray(scores['scores'][name][var])
      assert np.abs(s - w).max() <= SCORES_RTOL * np.abs(w).max(), (name,
                                                                    var)
