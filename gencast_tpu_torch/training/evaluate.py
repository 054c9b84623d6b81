"""Evaluation CLI: restore a checkpoint, roll a forecast out, score it.

Counterpart of `gencast_tpu.training.evaluate`: rebuilds the model and
wrapper stack from the same flags as the training CLI, restores the newest
checkpoint of `--ckpt_dir` (parameters only; the bf16 serving copy is
refreshed from them), takes the first window of the source (`--data`:
synthetic, or an ERA5 directory as in the training CLI) as the initial
state and its frames as the truth, samples a `--num_members` ensemble over
`--max_rollout_steps` 12-hour steps (free-running, or teacher-forced), its
members batched as the reference's: all of them as one batch by default
(the reference's vmapped ensemble), `--member_chunk N` members per batch,
each batch moved to the host as it ends, or with `--chunk_size N` each
member alone, its steps N at a time through `rollout.chunked_rollout`, as
the 0.25-degree model needs; or with `--model graphcast` predicts one
deterministic forecast (`rollout.predict_rollout`, or
`chunked_rollout(mode='predict')` under `--chunk_size`), and writes
`metrics.json` (per-variable RMSE of the ensemble mean; CRPS and spread
with more than one member, the reference's keys) and `rollout.npz`
(predictions [M, K, lat, lon, C], truth, lat, lon), with `--save_netcdf`
`rollout.nc` (the ensemble mean and the truth as NetCDF4; skipped with a
message where h5py is missing, as the reference's), plus a triptych PNG
and a GIF per `--plot_vars` name (matplotlib). Runs on the card unless
`--device cpu`; without a card it raises.

Example (1-degree, two members, two steps, from a training checkpoint):
  python -m gencast_tpu_torch.training.evaluate --preset 1deg \
      --ckpt_dir /path/to/ckpt --num_members 2 --max_rollout_steps 2 \
      --clean_sst_nans --out_dir /path/to/eval

  # From an ERA5 directory (NetCDF files or npz shards), with NetCDF out:
  python -m gencast_tpu_torch.training.evaluate --preset nano \
      --data /path/to/era5 --ckpt_dir /path/to/ckpt --num_members 2 \
      --max_rollout_steps 2 --save_netcdf --out_dir /path/to/eval

  # GraphCast_small (1 degree) from a GraphCast training checkpoint:
  python -m gencast_tpu_torch.training.evaluate --model graphcast \
      --preset 1deg --ckpt_dir /path/to/ckpt --max_rollout_steps 2 \
      --out_dir /path/to/eval

  # 0.25 degree (the paper's model), one member, steps one at a time:
  python -m gencast_tpu_torch.training.evaluate --preset 0.25deg \
      --clean_sst_nans --num_members 1 --max_rollout_steps 2 \
      --chunk_size 1 --plot_vars --out_dir /path/to/eval
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from gencast_tpu_torch.training import train

@dataclasses.dataclass
class EvalRun:
  """What a run leaves: the scores written to metrics.json, the predictions
  [M, K, lat, lon, C] and the wrapper stack that made them."""
  results: dict
  predictions: np.ndarray
  model: torch.nn.Module


def parse_args(argv=None):
  p = argparse.ArgumentParser(
      description='Evaluate GenCast or GraphCast (PyTorch port, CUDA '
                  'kernels on the card).')
  train.add_model_flags(p)
  p.add_argument('--ckpt_dir', default=None)
  p.add_argument('--out_dir',
                 default=os.path.join(tempfile.gettempdir(), 'gencast_eval'))
  p.add_argument('--max_rollout_steps', type=int, default=4)
  p.add_argument('--num_members', type=int, default=1)
  p.add_argument('--teacher_forcing', action='store_true')
  p.add_argument('--plot_vars', nargs='*', default=['2m_temperature'])
  p.add_argument('--chunk_size', type=int, default=None,
                 help='roll each member out this many steps at a time, '
                      'moving each chunk of predictions to the host '
                      '(rollout.chunked_rollout; the same forecast, at most '
                      'a chunk of steps on the card: use it at 0.25deg)')
  p.add_argument('--member_chunk', type=int, default=None,
                 help='sample this many ensemble members as one batch, '
                      'moving each batch to the host as it ends (default: '
                      'all members in one batch; the grouping does not '
                      'change a member; not used with --chunk_size, whose '
                      'members run one at a time)')
  p.add_argument('--no_overlap_offload', action='store_true',
                 help='with --chunk_size, copy each chunk to the host before '
                      'the next starts (default: while the next computes)')
  p.add_argument('--save_netcdf', action='store_true',
                 help='write the ensemble-mean rollout (+ matching '
                      'targets) as compressed NetCDF4, rollout.nc (h5py '
                      'dimension-scale writer; no xarray needed). Skipped '
                      'with a message if h5py is unavailable.')
  args = p.parse_args(argv)
  train.check_model_flags(p, args)
  if args.chunk_size is not None and args.chunk_size < 1:
    p.error(f'--chunk_size must be positive, got {args.chunk_size}')
  if args.member_chunk is not None and args.member_chunk < 1:
    p.error(f'--member_chunk must be positive, got {args.member_chunk}')
  return args


def per_variable_rmse(preds: np.ndarray, truth: np.ndarray,
                      layout) -> Dict[str, float]:
  """RMSE per variable over all its channels, NaNs skipped."""
  out = {}
  for name in layout.var_names:
    ch = layout.var_channels(name)
    d = preds[..., ch] - truth[..., ch]
    out[name] = float(np.sqrt(np.nanmean(d ** 2)))
  return out


def main(argv=None) -> EvalRun:
  args = parse_args(argv)
  from gencast_tpu_torch import rollout
  from gencast_tpu_torch.data import layout as layout_lib
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import metrics as metrics_lib
  from gencast_tpu_torch.parallel import ensemble as ensemble_lib
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import plotting

  device = train.select_device(args.device)
  spec = train.build_spec(args)
  model, statics = train.build_model(args, spec, device)
  task = model.task
  lat, lon = np.asarray(statics.grid_lat), np.asarray(statics.grid_lon)
  if args.data == 'synthetic':
    source = sources.SyntheticSource(
        task, lat, lon,
        num_times=args.max_rollout_steps + task.num_input_frames + 2,
        seed=args.seed + 1)
  else:
    source = train.era5_source_factory(args.data, task,
                                       spec.resolution_deg)()
    train.require_frames(
        source, task.num_input_frames + args.max_rollout_steps, args.data,
        f'a {args.max_rollout_steps}-step rollout '
        f'({task.num_input_frames} input frames and '
        f'{args.max_rollout_steps} targets)')
  source.forcing_device = device  # TISR, where the task has it
  stats = train.load_or_compute_stats(args, source, task, 'eval',
                                      save=False)

  wrapped = train.build_wrapped(args, spec, model, stats, device, 'eval')
  if args.ckpt_dir:
    step = ckpt_lib.restore(ckpt_lib.create_manager(args.ckpt_dir), wrapped)
    print(f'[eval] restored checkpoint step {step}', flush=True)
  else:
    print('[eval] WARNING: no checkpoint, evaluating untrained weights',
          flush=True)

  k = args.max_rollout_steps
  w = source.sample(0, num_target_frames=k)
  # sample() returns unstacked [lat, lon, C] for a single target frame.
  w_targets = w.targets if k > 1 else w.targets[None]
  w_forcings = w.forcings if k > 1 else w.forcings[None]
  inputs = torch.as_tensor(w.inputs)[None].to(device)
  forcings = torch.as_tensor(w_forcings)[:, None].to(device)  # [K, B=1]
  truth = np.asarray(w_targets)                              # [K, lat, lon, C]
  teacher = (torch.as_tensor(w_targets)[:, None].to(device)
             if args.teacher_forcing else None)
  if args.model == 'graphcast':
    if args.chunk_size:
      preds = rollout.chunked_rollout(
          wrapped, inputs, forcings, chunk_size=args.chunk_size,
          mode='predict', teacher_targets=teacher,
          overlap_offload=not args.no_overlap_offload)
    else:
      preds = rollout.predict_rollout(wrapped, inputs, forcings,
                                      teacher_targets=teacher).cpu()
    preds = preds[None]                                # one member
    members = 1
  else:
    # The reference's three modes: --chunk_size streams members one at a
    # time through the chunked rollout; otherwise --member_chunk members,
    # or all of them, sample as one batch.
    preds = ensemble_lib.ensemble_rollout(
        wrapped, inputs, forcings, seed=args.seed,
        num_members=args.num_members, teacher_targets=teacher,
        member_chunk=args.member_chunk, chunk_size=args.chunk_size,
        overlap_offload=not args.no_overlap_offload)
    members = args.num_members
  preds = preds[:, :, 0].numpy()                       # [M, K, lat, lon, C]
  ens_mean = preds.mean(axis=0)

  d = wrappers.find_layout_provider(model)
  rmse = per_variable_rmse(ens_mean, truth, d.target_layout)
  results = {'rmse': rmse, 'steps': k, 'members': members}
  if preds.shape[0] > 1:
    # The probabilistic scores, a band of latitudes at a time.
    scores = metrics_lib.score_ensemble_chunked(
        preds, truth, layout_lib.latitude_weights(lat), device=device)
    for name in ('crps', 'spread'):
      results[name] = {var: float(v) for var, v in metrics_lib.per_variable(
          scores[name].mean(axis=0), d.target_layout).items()}

  os.makedirs(args.out_dir, exist_ok=True)
  with open(os.path.join(args.out_dir, 'metrics.json'), 'w') as f:
    json.dump(results, f, indent=2)
  print('[eval] per-variable RMSE:')
  for name, v in rmse.items():
    print(f'  {name}: {v:.4f}')
  if 'crps' in results:
    print('[eval] per-variable CRPS:')
    for name, v in results['crps'].items():
      print(f'  {name}: {v:.4f}')
  np.savez(os.path.join(args.out_dir, 'rollout.npz'), predictions=preds,
           truth=truth, lat=lat, lon=lon)

  if args.save_netcdf:
    # The reference's deliverable artifact format (compressed NetCDF of
    # predictions + target_* variables, evaluation.py:194-260).
    try:
      from gencast_tpu_torch.data import netcdf_writer
      nc_path = os.path.join(args.out_dir, 'rollout.nc')
      netcdf_writer.write_forecast(
          nc_path, ens_mean, d.target_layout, lat, lon, truth=truth,
          global_attrs={'members': members, 'steps': k,
                        'rmse_mean': float(np.mean(list(rmse.values())))})
      print(f'[eval] NetCDF rollout written to {nc_path}', flush=True)
    except ImportError as e:
      print(f'[eval] --save_netcdf skipped: {e}', flush=True)

  for var in args.plot_vars:
    if var not in d.target_layout.var_names:
      continue
    ch = d.target_layout.var_channels(var)[0]
    plotting.plot_triptych(ens_mean[-1, :, :, ch], truth[-1, :, :, ch], lat,
                           lon, var,
                           os.path.join(args.out_dir, f'triptych_{var}.png'))
    plotting.rollout_gif(ens_mean[:, :, :, ch], lat, lon, var,
                         os.path.join(args.out_dir, f'rollout_{var}.gif'))
  print(f'[eval] outputs written to {args.out_dir}', flush=True)
  return EvalRun(results=results, predictions=preds, model=wrapped)


if __name__ == '__main__':
  main()
