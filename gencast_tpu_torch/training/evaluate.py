"""Evaluation CLI: restore a checkpoint, sample an ensemble rollout, score it.

Counterpart of `gencast_tpu.training.evaluate` for the synthetic source:
rebuilds the model and wrapper stack from the same flags as the training
CLI, restores the newest checkpoint of `--ckpt_dir` (parameters only; the
bf16 serving copy is refreshed from them), samples a `--num_members`
ensemble over `--max_rollout_steps` 12-hour steps (free-running, or
teacher-forced; each `--member_chunk` members, default 1, move to the host
as they end), and writes `metrics.json` (per-variable RMSE of the
ensemble mean; CRPS and spread with more than one member, the reference's
keys) and `rollout.npz` (predictions [M, K, lat, lon, C], truth, lat,
lon), plus a triptych PNG and a GIF per `--plot_vars` name (matplotlib).
Runs on the card unless `--device cpu`; without a card it raises.

Example (1-degree, two members, two steps, from a training checkpoint):
  python -m gencast_tpu_torch.training.evaluate --preset 1deg \
      --ckpt_dir /path/to/ckpt --num_members 2 --max_rollout_steps 2 \
      --clean_sst_nans --out_dir /path/to/eval
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

# Options of the reference's CLI that the port does not take yet, with the
# ROADMAP.md item ("Still to port") that brings them.
_LATER_OPTIONS = {'chunk_size': '0.25 degree',
                  'no_overlap_offload': '0.25 degree',
                  'save_netcdf': 'CLIs and data'}


@dataclasses.dataclass
class EvalRun:
  """What a run leaves: the scores written to metrics.json, the predictions
  [M, K, lat, lon, C] and the wrapper stack that made them."""
  results: dict
  predictions: np.ndarray
  model: torch.nn.Module


def parse_args(argv=None):
  p = argparse.ArgumentParser(
      description='Evaluate GenCast (PyTorch port, CUDA kernels on the card).')
  train.add_model_flags(p)
  p.add_argument('--ckpt_dir', default=None)
  p.add_argument('--out_dir',
                 default=os.path.join(tempfile.gettempdir(), 'gencast_eval'))
  p.add_argument('--max_rollout_steps', type=int, default=4)
  p.add_argument('--num_members', type=int, default=1)
  p.add_argument('--teacher_forcing', action='store_true')
  p.add_argument('--plot_vars', nargs='*', default=['2m_temperature'])
  p.add_argument('--chunk_size', type=int, default=None,
                 help='not ported yet (0.25 degree)')
  p.add_argument('--member_chunk', type=int, default=None,
                 help='run ensemble members in groups of this size, moving '
                      'each group to the host as it ends (default 1; the '
                      'grouping does not change a member)')
  p.add_argument('--no_overlap_offload', action='store_true',
                 help='not ported yet (0.25 degree)')
  p.add_argument('--save_netcdf', action='store_true',
                 help='not ported yet (the ERA5 data path)')
  args = p.parse_args(argv)
  train.check_model_flags(p, args)
  for option, item in _LATER_OPTIONS.items():
    if getattr(args, option):
      train.later(p, f'--{option}', item)
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
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import layout as layout_lib
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.ops import metrics as metrics_lib
  from gencast_tpu_torch.parallel import ensemble as ensemble_lib
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import plotting

  device = train.select_device(args.device)
  spec = train.build_spec(args)
  model, statics = configs.build_gencast(spec, seed=args.seed, device=device)
  task = model.task
  lat, lon = np.asarray(statics.grid_lat), np.asarray(statics.grid_lon)
  source = sources.SyntheticSource(
      task, lat, lon,
      num_times=args.max_rollout_steps + task.num_input_frames + 2,
      seed=args.seed + 1)
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
  preds = ensemble_lib.ensemble_rollout(
      wrapped, inputs, forcings, seed=args.seed,
      num_members=args.num_members, teacher_targets=teacher,
      member_chunk=args.member_chunk)
  preds = preds[:, :, 0].numpy()                       # [M, K, lat, lon, C]
  ens_mean = preds.mean(axis=0)

  d = model.denoiser
  rmse = per_variable_rmse(ens_mean, truth, d.target_layout)
  results = {'rmse': rmse, 'steps': k, 'members': args.num_members}
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
