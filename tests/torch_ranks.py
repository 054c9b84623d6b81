"""Spawned ranks for the port's multi-process tests (no JAX here: each rank
imports this module and the port only).

`run_ranks` starts `world` 'spawn' processes on localhost, each running
fn(rank, world, coordinator, *args), and fails the test if one fails or if
they are not all done within `timeout` seconds (then it kills them).
`run_cli` runs a module of the port as a command in its own session with a
timeout, killing its whole process group (its ranks too) when it runs out.
"""

import multiprocessing
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Seconds each spawned process, or command, may take.
RANK_TIMEOUT = 60


def run_ranks(fn, world, args=(), timeout=RANK_TIMEOUT):
  from gencast_tpu_torch.parallel import meshes
  ctx = multiprocessing.get_context('spawn')
  coordinator = f'127.0.0.1:{meshes.free_port()}'
  procs = [ctx.Process(target=fn, args=(rank, world, coordinator) + tuple(args))
           for rank in range(world)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + timeout
  try:
    for p in procs:
      p.join(max(0.0, deadline - time.monotonic()))
  finally:
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
      p.kill()
      p.join()
  assert not alive, f'{len(alive)} ranks still running after {timeout} s'
  assert [p.exitcode for p in procs] == [0] * world, [p.exitcode
                                                       for p in procs]


def run_cli(module, argv, timeout=RANK_TIMEOUT):
  """`python -m module argv` from the repository root, one CPU thread per
  process; returns its stdout, and fails with its output if it fails."""
  env = dict(os.environ, OMP_NUM_THREADS='1')
  proc = subprocess.Popen([sys.executable, '-m', module] + list(argv),
                          cwd=REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True)
  try:
    out, err = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()
    raise AssertionError(f'{module} {argv}: not done in {timeout} s')
  assert proc.returncode == 0, f'{module} exit {proc.returncode}\n{out}\n{err}'
  return out


def parallel_rank(rank, world, coordinator, out_dir):
  """One rank of tests/test_torch_parallel.py: the member-sharded functions
  over an ensemble axis of `world` ranks on the CPU; writes what it got to
  out_dir/rank<r>.npz."""
  import numpy as np
  import torch
  from gencast_tpu_torch.parallel import ensemble, meshes
  torch.set_num_threads(1)  # the parent's summation order
  meshes.initialize(coordinator, world, rank, device='cpu')
  try:
    mesh = meshes.make_mesh(ensemble=world)
    members, truth, lat_w = scoring_data()
    lo, hi = ensemble.member_range(members.shape[0], mesh)
    local = torch.as_tensor(members[lo:hi])
    scores = ensemble.ensemble_scores(local, torch.as_tensor(truth),
                                      torch.as_tensor(lat_w), mesh)
    mean, std = ensemble.ensemble_statistics(local, mesh)
    out = {f'score_{k}': v.numpy() for k, v in scores.items()}
    out.update(gathered=ensemble.gather_members(local, mesh).numpy(),
               mean=mean.numpy(), std=std.numpy())
    wrapped, _, inputs, forcings = sampling_inputs()
    samples = ensemble.ensemble_sample(wrapped, inputs, forcings[0],
                                       seed=1, num_members=3, mesh=mesh)
    run = ensemble.make_ensemble_rollout(wrapped, mesh)
    rollouts = run(inputs, forcings, 2, range(3))
    out.update(local_samples=samples.numpy(),
               samples=ensemble.gather_members(samples, mesh).numpy(),
               rollouts=ensemble.gather_members(rollouts, mesh).numpy())
    np.savez(os.path.join(out_dir, f'rank{rank}.npz'), **out)
  finally:
    meshes.shutdown()


def scoring_data():
  """Seeded members [5, 2, 19, 36, 3], truth and the 10-degree grid's
  latitude weights (float32)."""
  import numpy as np
  from gencast_tpu_torch.data import layout
  rng = np.random.default_rng(0)
  members = rng.standard_normal((5, 2, 19, 36, 3)).astype(np.float32)
  truth = rng.standard_normal((2, 19, 36, 3)).astype(np.float32)
  lat = np.arange(-90.0, 90.0 + 5.0, 10.0, dtype=np.float32)
  return members, truth, layout.latitude_weights(lat).astype(np.float32)


def sampling_inputs():
  """The toy GenCast of tools/multihost_smoke.py (wrapped), with seeded
  inputs [1, lat, lon, C] and forcings of 2 steps [2, 1, lat, lon, C]."""
  import numpy as np
  import torch
  from gencast_tpu_torch.tools import multihost_smoke
  wrapped, model, lat, lon = multihost_smoke.toy_model('cpu')
  d = model.denoiser
  rng = np.random.default_rng(3)
  inputs = torch.as_tensor(rng.standard_normal(
      (1, lat.size, lon.size, d.input_layout.num_channels)).astype(np.float32))
  forcings = torch.as_tensor(rng.standard_normal(
      (2, 1, lat.size, lon.size, d.forcing_layout.num_channels)).astype(
          np.float32))
  return wrapped, model, inputs, forcings
