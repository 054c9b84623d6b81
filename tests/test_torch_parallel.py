"""The port's parallel layer (`gencast_tpu_torch.parallel`) against the JAX
package's on the CPU.

- `local_batch_plan` and `assemble_local_batch`: the rows each rank packs
  and its shard, against `gencast_tpu.parallel.meshes` on the same mesh
  shapes over the 8 virtual devices of tests/conftest.py (a rank of the
  port is a device there), and `make_mesh`'s refusals of grids that are
  not the number of ranks (a model axis among them).
- Over 2 spawned gloo ranks on the CPU (tests/torch_ranks.py, each with its
  own timeout): `ensemble_scores` of 5 members (2 and 3 per rank, latitude
  bands of 9 and 10 rows) against `gencast_tpu.parallel.ensemble
  .ensemble_scores` within SCORES_RTOL; `gather_members` bitwise the
  members; `ensemble_statistics` against torch's on all members; and
  `ensemble_sample` and `make_ensemble_rollout` of the toy GenCast of
  tools/multihost_smoke.py bitwise the one-rank members (and the rollout
  bitwise the one-device `ensemble_rollout`).
- The multi-process smoke tool itself, as a command of four ranks.
"""

import re

import jax
import numpy as np
import pytest
import torch

from gencast_tpu.parallel import ensemble as jax_ensemble
from gencast_tpu.parallel import meshes as jax_meshes
from gencast_tpu_torch.parallel import ensemble, meshes
from tests import torch_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# ensemble_scores over ranks against JAX's on the gathered members, max
# relative: float32 sums over latitude bands, then across ranks.
SCORES_RTOL = 1e-5
# ensemble_statistics over ranks against torch's mean and std on all
# members: float32 sums in another order.
STATS_RTOL = 1e-6
SHAPES = [(1, 8, 1), (2, 4, 1), (4, 2, 1), (8, 1, 1), (2, 2, 2)]


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_local_batch_plan_rows_are_jax(shape):
  """Each rank packs the rows, and assembles the shard, that JAX's
  local_batch_plan gives the device at its place on a mesh of the same
  shape (devices and ranks in the same order)."""
  batch_size = 8
  mesh = jax_meshes.make_mesh(*shape)
  rows, blocks = jax_meshes.local_batch_plan(mesh, batch_size)
  rng = np.random.default_rng(0)
  batch = {'inputs': rng.standard_normal((batch_size, 3, 2)).astype(
      np.float32)}
  shards = jax_meshes.assemble_local_batch(mesh, batch_size, blocks,
                                           {k: v[rows] for k, v in
                                            batch.items()})['inputs']
  by_device = {s.device: np.asarray(s.data)
               for s in shards.addressable_shards}
  for device, sl in blocks:
    place = tuple(int(i) for i in np.argwhere(mesh.devices == device)[0])
    rank = int(np.ravel_multi_index(place, shape))
    port = meshes.Mesh(shape=shape, rank=rank)
    assert port.coords == dict(zip(meshes.AXES, place))
    port_rows, port_blocks = meshes.local_batch_plan(port, batch_size)
    np.testing.assert_array_equal(port_rows, rows[sl])
    got = meshes.assemble_local_batch(
        port, batch_size, port_blocks,
        {k: v[port_rows] for k, v in batch.items()})['inputs']
    np.testing.assert_array_equal(got.numpy(), by_device[device])


def test_make_mesh_refuses_what_it_cannot_build():
  """One process without a process group is the (1, 1, 1) mesh; a grid of
  another size is refused, a model axis too: it is a grid of 2 ranks."""
  mesh = meshes.make_mesh()
  assert (mesh.shape, mesh.rank, mesh.groups) == ((1, 1, 1), 0, {})
  assert mesh.coords == {'ensemble': 0, 'data': 0, 'model': 0}
  with pytest.raises(ValueError, match='!= 1 ranks'):
    meshes.make_mesh(ensemble=2)
  with pytest.raises(ValueError, match=r'1x1x2=2 != 1 ranks'):
    meshes.make_mesh(model=2)
  with pytest.raises(ValueError, match='divisible'):
    meshes.local_batch_plan(meshes.Mesh(shape=(1, 4, 1), rank=1), 6)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
  out = tmp_path_factory.mktemp('ranks')
  torch_ranks.run_ranks(torch_ranks.parallel_rank, 2, (str(out),))
  return [dict(np.load(out / f'rank{r}.npz')) for r in range(2)]


def test_ensemble_scores_over_ranks_match_jax(two_ranks):
  members, truth, lat_w = torch_ranks.scoring_data()
  want = jax.device_get(jax_ensemble.ensemble_scores(members, truth, lat_w))
  for got in two_ranks:  # replicated: every rank has the scores
    for name in ('crps', 'rmse', 'spread'):
      w = np.asarray(want[name])
      assert got[f'score_{name}'].shape == w.shape == (2, 3)
      rel = np.abs(got[f'score_{name}'] - w).max() / np.abs(w).max()
      assert rel <= SCORES_RTOL, (name, rel)
  np.testing.assert_array_equal(two_ranks[0]['score_crps'],
                                two_ranks[1]['score_crps'])


def test_gather_and_statistics_over_ranks(two_ranks):
  members, _, _ = torch_ranks.scoring_data()
  full = torch.as_tensor(members)
  mean, std = full.mean(0), full.std(0, correction=1)
  for got in two_ranks:
    assert np.array_equal(got['gathered'].view(np.uint32),
                          members.view(np.uint32))
    for name, want in (('mean', mean), ('std', std)):
      rel = np.abs(got[name] - want.numpy()).max() / want.abs().max()
      assert rel <= STATS_RTOL, (name, rel)


def test_sharded_members_are_the_one_rank_members(two_ranks):
  """Rank r draws members [r·M/E, (r+1)·M/E) from their own (seed, m)
  generators: gathered, they are bitwise one rank's (and the one-device
  ensemble_rollout's) members."""
  wrapped, _, inputs, forcings = torch_ranks.sampling_inputs()
  samples = ensemble.ensemble_sample(wrapped, inputs, forcings[0], seed=1,
                                     num_members=3)
  rollouts = ensemble.make_ensemble_rollout(wrapped)(inputs, forcings, 2,
                                                     range(3))
  streamed = ensemble.ensemble_rollout(wrapped, inputs, forcings, seed=2,
                                       num_members=3)
  assert torch.equal(streamed, rollouts)
  assert rollouts.shape[:2] == (3, 2)
  for rank, got in enumerate(two_ranks):
    np.testing.assert_array_equal(got['samples'], samples.numpy())
    np.testing.assert_array_equal(got['rollouts'], rollouts.numpy())
    lo, hi = (0, 1) if rank == 0 else (1, 3)
    np.testing.assert_array_equal(got['local_samples'],
                                  samples[lo:hi].numpy())


def test_member_range_splits_the_members():
  assert ensemble.member_range(5) == (0, 5)
  ranges = [ensemble.member_range(5, meshes.Mesh(shape=(2, 1, 1), rank=r))
            for r in range(2)]
  assert ranges == [(0, 2), (2, 5)]
  with pytest.raises(ValueError, match='would run none'):
    ensemble.member_range(1, meshes.Mesh(shape=(2, 1, 1), rank=0))


def test_multihost_smoke_tool():
  """Four ranks (ensemble 2 x data 2): one data-parallel step and a
  2-member sample, the same loss and sum on every rank."""
  out = torch_ranks.run_cli('gencast_tpu_torch.tools.multihost_smoke',
                            ['--num_processes', '4', '--device', 'cpu'])
  # Each rank writes its line in one write; another rank's text may come
  # first on the same line.
  done = sorted(re.findall(r'MULTIHOST_OK (p\d/4) (loss=\S+ sum=\S+)\n', out))
  assert [rank for rank, _ in done] == [f'p{r}/4' for r in range(4)]
  assert len({result for _, result in done}) == 1
