"""Training CLI (GenCast on synthetic data).

Counterpart of `gencast_tpu.training.train` for the paths the port runs:
the TINY and 1-degree presets on the synthetic source, one training step
per batch, on the CUDA card when there is one (the kernels) and on the CPU
otherwise (their plain versions). Flags keep the reference's names,
defaults and meanings.

Examples:
  # Smoke-train a tiny model on synthetic data (CPU-friendly):
  python -m gencast_tpu_torch.training.train --preset tiny --steps 3 \
      --data synthetic

  # Three full-width 1-degree steps on one H100:
  python -m gencast_tpu_torch.training.train --preset 1deg --steps 3 \
      --data synthetic --clean_sst_nans
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np
import torch

# Presets and data the reference's CLI takes and the port does not yet, with
# the ROADMAP.md item ("Still to port") that brings them.
_LATER_PRESETS = {'nano': 'Nano', '0.25deg': '0.25 degree'}
_LATER_DATA = 'CLIs and checkpoints (the ERA5 sources)'


@dataclasses.dataclass
class TrainRun:
  """What a run leaves: the trained wrapper stack, the mean loss of every
  step, and the seconds each step took (host clock, the device synchronized
  at its end; batch packing excluded)."""
  model: torch.nn.Module
  losses: List[float]
  step_seconds: List[float]


def parse_args(argv=None):
  p = argparse.ArgumentParser(
      description='Train GenCast (PyTorch port, CUDA kernels on the card).')
  p.add_argument('--preset', default='nano',
                 help='tiny or 1deg (nano and 0.25deg are not ported yet)')
  p.add_argument('--data', default='synthetic',
                 help="'synthetic' (ERA5 directories are not ported yet)")
  p.add_argument('--steps', type=int, default=30000)
  p.add_argument('--batch_size', type=int, default=1)
  p.add_argument('--learning_rate', type=float, default=3e-4)
  p.add_argument('--warmup_steps', type=int, default=1000)
  p.add_argument('--weight_decay', type=float, default=0.1)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                 default=None,
                 help='bf16 compute with f32 master weights '
                      '(default: the preset decides; --no-bf16 forces f32)')
  p.add_argument('--clean_sst_nans', action='store_true',
                 help='fill the NaNs of sea_surface_temperature (land) '
                      'before the model sees them (NaNCleaner)')
  p.add_argument('--log_every', type=int, default=10)
  args = p.parse_args(argv)
  if args.preset in _LATER_PRESETS:
    p.error(f'--preset {args.preset} is not ported yet: ROADMAP.md, '
            f'"Still to port": {_LATER_PRESETS[args.preset]}')
  if args.preset not in ('tiny', '1deg'):
    p.error(f'unknown --preset {args.preset!r}: tiny or 1deg')
  if args.data != 'synthetic':
    p.error(f'--data {args.data!r}: only synthetic data is ported; ERA5 '
            f'sources come with ROADMAP.md, "Still to port": {_LATER_DATA}')
  return args


def setup(args):
  """Everything a run of `args` needs: (the wrapped model stack, its
  optimizer, the batch iterator, the noise generator, the device), on the
  CUDA card when there is one."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.training import steps as steps_lib

  spec = {'tiny': configs.TINY, '1deg': configs.ONE_DEG}[args.preset]
  device = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
  print(f'[train] spec={spec.name} mesh_splits={spec.mesh_splits} '
        f'd_model={spec.d_model} layers={spec.num_layers} device={device}',
        flush=True)
  model, statics = configs.build_gencast(spec, seed=args.seed, device=device)
  task = model.task

  source = sources.SyntheticSource(
      task, np.asarray(statics.grid_lat), np.asarray(statics.grid_lon),
      num_times=max(40, args.batch_size * 8), seed=args.seed)
  print(f'[train] data source: {type(source).__name__}, {len(source)} '
        f'samples', flush=True)
  stats = sources.compute_stats(source)

  bf16 = args.bf16 or (args.bf16 is None and spec.cast_bf16)
  if bf16:
    print('[train] bf16 compute enabled (f32 master weights)')
  wrapped = wrappers.build_stack(model, stats, bf16=bf16,
                                 clean_sst_nans=args.clean_sst_nans).to(device)
  optimizer = steps_lib.create_optimizer(
      wrapped, steps_lib.OptimizerConfig(
          learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
          total_steps=args.steps, weight_decay=args.weight_decay))

  generator = torch.Generator(device=device).manual_seed(args.seed)
  it = sources.batch_iterator(source, args.batch_size, seed=args.seed)
  return wrapped, optimizer, it, generator, device


def main(argv=None) -> TrainRun:
  args = parse_args(argv)
  from gencast_tpu_torch.training import steps as steps_lib
  wrapped, optimizer, it, generator, device = setup(args)
  losses: List[torch.Tensor] = []
  run = TrainRun(model=wrapped, losses=[], step_seconds=[])
  t_log = time.perf_counter()
  for step in range(args.steps):
    batch = {k: torch.as_tensor(v).to(device) for k, v in next(it).items()}
    _synchronize(device)
    t0 = time.perf_counter()
    loss, _ = steps_lib.train_step(wrapped, optimizer, batch['inputs'],
                                   batch['targets'], batch['forcings'],
                                   generator)
    _synchronize(device)
    run.step_seconds.append(time.perf_counter() - t0)
    losses.append(loss)
    if (step + 1) % args.log_every == 0:
      dt = time.perf_counter() - t_log
      mean_loss = float(torch.stack(losses[-args.log_every:]).mean())
      print(f'[train] step {step + 1}/{args.steps} loss={mean_loss:.4f} '
            f'{args.log_every / dt:.2f} steps/s', flush=True)
      t_log = time.perf_counter()
  run.losses = [float(x) for x in losses]
  _refresh_bf16(wrapped)
  print('[train] done', flush=True)
  return run


def _synchronize(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _refresh_bf16(model: torch.nn.Module) -> None:
  """Remakes the serving copy of every Bfloat16Cast from the trained
  master weights."""
  from gencast_tpu_torch.models import casting
  for m in model.modules():
    if isinstance(m, casting.Bfloat16Cast):
      m.refresh()


if __name__ == '__main__':
  main()
