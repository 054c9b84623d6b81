"""Pod-scale ensemble forecast: members sharded over ranks.

Counterpart of the reference's `scripts/ensemble_forecast_pod.py` (one
process per host, members over the 'ensemble' mesh axis), as
`python -m gencast_tpu_torch.scripts.ensemble_forecast_pod`. The ranks are
processes (`torch.distributed`, parallel/meshes.py): `--multihost` makes
this process one rank of `--num_processes` (`--process_id`, the TCP store
at `--coordinator`, or torchrun's environment); without it, `--num_processes
N` starts N local ranks itself, as the reference runs on a host of N
devices. The ensemble axis gets the largest divisor of the number of ranks
that the member count fills, as the reference's rule, and the factor left
over is the model axis (tensor parallelism, parallel/tensor.py): the ranks
of one ensemble coordinate compute its members together, each holding its
slices of the attention heads and MLP hidden widths, eagerly (their
all_reduces are not captured into CUDA graphs). As the reference's pod,
the members run in chunks of E, one call of `parallel.ensemble.
make_ensemble_rollout` per chunk, one member per ensemble coordinate and
call (coordinate e runs members e, e + E, ...); a member count E does not
divide is padded to the next multiple of E and the padded members are
discarded. Member m draws from the generator of (0, m), so a member does
not depend on the rank count; its members stay on its devices.

--score computes CRPS, ensemble-mean RMSE and spread against the source's
targets on the devices (parallel.ensemble.ensemble_scores: members
resharded to latitude bands, reduced over the ensemble axis) and rank 0
writes per-variable scores JSON; with --no-save_members only those scores
reach the host. Otherwise each member is saved once, by the rank at model
coordinate 0 of its ensemble coordinate e (`--out`, with `.p<e>` before
the extension when there is more than one rank), the model replicas
deduplicated as in the reference. Runs on the card unless `--device cpu`.

  # 50 members x 30 steps of 1-degree GenCast over the ranks of 4 hosts:
  python -m gencast_tpu_torch.scripts.ensemble_forecast_pod --preset 1deg \
      --ckpt_dir /ckpt/1deg --data /data/era5 --members 50 --steps 30 \
      --multihost --coordinator host0:29500 --num_processes 4 \
      --process_id <r> --clean_sst_nans

  # Two local ranks on the CPU, scores only:
  python -m gencast_tpu_torch.scripts.ensemble_forecast_pod --preset tiny \
      --device cpu --members 2 --steps 2 --num_processes 2 --score \
      --no-save_members

  # Four local ranks for 2 members: ensemble 2 x model 2:
  python -m gencast_tpu_torch.scripts.ensemble_forecast_pod --preset tiny \
      --device cpu --members 2 --steps 2 --num_processes 4 --score
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import types
from typing import List

import numpy as np
import torch


def parse_args(argv=None):
  p = argparse.ArgumentParser(
      description='Member-sharded ensemble forecast (PyTorch port).')
  p.add_argument('--preset', default='1deg')
  p.add_argument('--data', default='synthetic',
                 help="'synthetic' or a directory of the npz shards of "
                      'tools.convert_era5')
  p.add_argument('--ckpt_dir', default=None)
  p.add_argument('--members', type=int, default=50)
  p.add_argument('--steps', type=int, default=30)
  p.add_argument('--out',
                 default=os.path.join(tempfile.gettempdir(), 'forecast.npz'))
  p.add_argument('--score', action='store_true',
                 help="compute CRPS/RMSE/spread vs the data source's "
                      'targets on the devices (parallel.ensemble.'
                      'ensemble_scores) and save per-variable scores JSON; '
                      'only the scores reach the host')
  p.add_argument('--save_members', action=argparse.BooleanOptionalAction,
                 default=True,
                 help='move the member forecast fields to the host and save '
                      'them (--no-save_members for score-only runs)')
  p.add_argument('--multihost', action='store_true',
                 help='this process is one rank of --num_processes '
                      '(torch.distributed over a TCP store at --coordinator, '
                      "or torchrun's environment)")
  p.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                 default=None,
                 help='bf16 compute (default: the preset decides); must '
                      'match how the checkpoint was trained')
  p.add_argument('--clean_sst_nans', action='store_true',
                 help='wrap with NaNCleaner, as in train.py; must match '
                      'how the checkpoint was trained')
  p.add_argument('--coordinator', default=None,
                 help="the TCP store's address under --multihost (default: "
                      "torchrun's environment)")
  p.add_argument('--process_id', type=int, default=None)
  p.add_argument('--num_processes', type=int, default=None,
                 help='under --multihost the number of ranks; without it, N '
                      '> 1 starts N local ranks')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the card, through the kernels) or 'cpu'")
  args = p.parse_args(argv)
  if not args.save_members and not args.score:
    p.error('--no-save_members without --score produces no output; '
            'add --score (or drop --no-save_members)')
  return args


def ensemble_axis(world: int, members: int) -> int:
  """The reference's rule: the largest divisor of the rank count that the
  member count fills (the rest is the model axis)."""
  return max(d for d in range(1, world + 1)
             if world % d == 0 and d <= max(1, members))


def build_forecast(args, device, mesh=None):
  """The wrapped model (seed 0, stats from the source, restored from
  --ckpt_dir when given; with a model axis in `mesh`, this rank's slices),
  its statics, and the source's first window of --steps targets as
  (inputs [1, ...], forcings [K, 1, ...], targets [K, 1, ...]) tensors on
  `device`."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import train
  spec = train.build_spec(types.SimpleNamespace(
      preset=args.preset, task=None, mesh_size=None, d_model=None,
      num_layers=None, num_heads=None, attention_k_hop=None,
      attention_type=None))
  model, statics = configs.build_gencast(spec, seed=0, device=device)
  task = model.task
  source = (sources.SyntheticSource(task, np.asarray(statics.grid_lat),
                                    np.asarray(statics.grid_lon),
                                    num_times=args.steps + 4)
            if args.data == 'synthetic'
            else sources.Era5NpzSource(args.data, task))
  stats = sources.compute_stats(source)
  wrapped = wrappers.build_stack(
      model, stats, bf16=args.bf16 or (args.bf16 is None and spec.cast_bf16),
      clean_sst_nans=args.clean_sst_nans).to(device)
  if args.ckpt_dir:
    manager = ckpt_lib.create_manager(args.ckpt_dir)
    step = ckpt_lib.restore(manager, wrapped)
    print(f'[forecast] restored step {step}', flush=True)
  train.shard(wrapped, mesh, 'forecast')
  w = source.sample(0, num_target_frames=args.steps)

  def frames(x):
    # [K, B=1, lat, lon, C]: a window of one target frame comes unstacked.
    x = np.asarray(x, np.float32)
    return x.reshape((args.steps, 1) + x.shape[-3:])

  window = tuple(torch.as_tensor(x).to(device)
                 for x in (np.asarray(w.inputs, np.float32)[None],
                           frames(w.forcings), frames(w.targets)))
  return wrapped, statics, window


def _local_rank(rank: int, world: int, coordinator: str,
                argv: List[str]) -> None:
  main(argv + ['--multihost', '--coordinator', coordinator, '--process_id',
               str(rank), '--num_processes', str(world)])


def main(argv=None) -> dict:
  argv = list(sys.argv[1:] if argv is None else argv)
  args = parse_args(argv)
  if not args.multihost and (args.num_processes or 1) > 1:
    from gencast_tpu_torch.parallel import meshes
    print(f'[forecast] starting {args.num_processes} local ranks', flush=True)
    meshes.spawn(_local_rank, args.num_processes, (argv,))
    return {}
  try:
    return _forecast(args)
  finally:
    if args.multihost:
      from gencast_tpu_torch.parallel import meshes
      meshes.shutdown()


def _forecast(args) -> dict:
  """This rank's part of the forecast; returns its numbers (seconds, member
  ids, scores) for the caller."""
  from gencast_tpu_torch.data import layout as layout_lib
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import metrics as metrics_lib
  from gencast_tpu_torch.parallel import ensemble, meshes
  from gencast_tpu_torch.training import train
  backend = None
  if args.multihost:
    backend, device = meshes.initialize(args.coordinator, args.num_processes,
                                        args.process_id, device=args.device)
  else:
    device = train.select_device(args.device)
  world = torch.distributed.get_world_size() if args.multihost else 1
  ens = ensemble_axis(world, args.members)
  mesh = meshes.make_mesh(ensemble=ens, model=world // ens)
  print(f'[forecast] rank {mesh.rank} of {world}, backend {backend}, device '
        f'{device}, mesh ensemble={ens} model={world // ens}', flush=True)

  wrapped, statics, (inputs, forcings, targets) = build_forecast(args, device,
                                                                 mesh)
  run = ensemble.make_ensemble_rollout(wrapped, mesh)
  # The reference's chunks: E members a call, this rank's the one at its
  # ensemble coordinate; members past the count (the padding) discarded.
  padded = -(-args.members // ens) * ens
  starts = range(0, padded, ens)
  train._synchronize(device)
  t0 = time.perf_counter()
  runs = [run(inputs, forcings, 0, range(lo, lo + ens)) for lo in starts]
  train._synchronize(device)
  dt = time.perf_counter() - t0
  ids = [lo + mesh.coords['ensemble'] for lo in starts]
  local = torch.cat([r for r, m in zip(runs, ids)
                     if m < args.members])  # [m, K, B, ...]
  ids = [m for m in ids if m < args.members]
  del runs
  # Seconds per kept member-step: a padded member's call is work done for
  # no member, so it is counted in the time and not in the divisor.
  out = {'rank': mesh.rank, 'members': ids, 'seconds': dt,
         'member_step_seconds': dt / (len(ids) * args.steps)}
  print(f'[forecast] rank {mesh.rank}: members {ids} x {args.steps} steps '
        f'in {dt:.2f} s ({out["member_step_seconds"]:.3f} s per kept '
        f'member-step, {len(starts)} calls of one member, '
        f'{len(starts) - len(ids)} of them padding; first calls '
        'included)\n', end='', flush=True)

  if args.score:
    t0 = time.perf_counter()
    lat_w = torch.as_tensor(layout_lib.latitude_weights(
        np.asarray(statics.grid_lat)), device=device)
    scores = ensemble.ensemble_scores(local, targets, lat_w, mesh)
    tgt_layout = wrappers.find_layout_provider(wrapped).target_layout
    out['scores'] = {
        name: {var: np.asarray(v)[:, 0].tolist()  # [K] per forecast step
               for var, v in metrics_lib.per_variable(arr,
                                                      tgt_layout).items()}
        for name, arr in scores.items()}
    print(f'[forecast] scores on the devices in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    if mesh.rank == 0:
      scores_path = f'{os.path.splitext(args.out)[0]}.scores.json'
      with open(scores_path, 'w') as f:
        json.dump({'members': args.members, 'steps': args.steps,
                   'scores': out['scores']}, f, indent=1)
      print(f'[forecast] saved scores to {scores_path}', flush=True)

  if args.save_members and mesh.coords['model'] == 0:
    path = args.out
    if world > 1:
      base, ext = os.path.splitext(args.out)
      path = f'{base}.p{mesh.coords["ensemble"]}{ext}'
    np.savez(path, predictions=local.cpu().numpy(),
             members=np.asarray(ids, dtype=np.int32),
             lat=np.asarray(statics.grid_lat),
             lon=np.asarray(statics.grid_lon))
    print(f'[forecast] saved members {ids} to {path}',
          flush=True)
  if device.type == 'cuda':
    from gencast_tpu_torch.ops import cuda_lib
    # One write per line: ranks may share a stdout.
    print(f'[forecast] kernel launches in this process (rank {mesh.rank} of '
          f'{world}) ' + json.dumps({c.name: c.launches
                                     for c in cuda_lib.COUNTERS}) + '\n',
          end='', flush=True)
  return out


if __name__ == '__main__':
  main()
