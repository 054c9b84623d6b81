"""Training CLI (GenCast on synthetic data).

Counterpart of `gencast_tpu.training.train` for the paths the port runs:
the TINY, nano and 1-degree presets on the synthetic source, one training
step per batch, on the CUDA card (the kernels) unless `--device cpu` asks
for the CPU (their plain versions). Flags keep the reference's names,
defaults and meanings: checkpoints with resume (`--ckpt_dir`,
`--save_every`), metrics (`--metrics_jsonl`, `--wandb`), stats files
(`--stats_path`), the sampling eval (`--eval_every`,
`--do_sampling_eval`), `--no_normalization` and the architecture
overrides. Every flag of the reference's CLI parses; those of paths not
ported yet are refused with the ROADMAP.md item that brings them, and the
TPU-only ones (`--functional_step`, `--cpu`) as such. `--ar_steps K` on a
GenCast run is the reference's no-op.

Randomness: step `s` draws its noise level and noise from a generator
seeded from (`--seed`, s) alone, as the reference folds the step into its
key, so a resumed run draws what an uninterrupted one would. As in the
reference, the batch stream is not saved: a resumed run starts it again
from its beginning.

Examples:
  # Smoke-train a tiny model on synthetic data on the CPU:
  python -m gencast_tpu_torch.training.train --preset tiny --steps 3 \
      --data synthetic --device cpu

  # Three full-width nano steps on one H100 (the default preset):
  python -m gencast_tpu_torch.training.train --steps 3 --data synthetic

  # Full-width 1-degree steps on one H100 with checkpoints; run it again
  # with a larger --steps to resume from the newest checkpoint:
  python -m gencast_tpu_torch.training.train --preset 1deg --steps 3 \
      --data synthetic --clean_sst_nans --ckpt_dir /path/to/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List

import numpy as np
import torch

_PRESETS = ('tiny', 'nano', '1deg')
# Presets, options and data the reference's CLIs take and the port does not
# yet, with the ROADMAP.md item ("Still to port") that brings them.
_LATER_PRESETS = {'0.25deg': '0.25 degree'}
_LATER_DATA = 'CLIs and data'
_LATER_GRAPHCAST = 'GraphCast'
_LATER_LAUNCHES = 'Host launches'
_LATER_PARALLEL = 'Parallelism'
_LATER_ATTENTION = {'triblock': "The reference's other attention backends",
                    'dense': "The reference's other attention backends"}
_ATTENTION_TYPES = ('pallas', 'triblock_pallas')


@dataclasses.dataclass
class TrainRun:
  """What a run leaves: the trained wrapper stack, the mean loss of every
  step it took, the seconds each step took (host clock, the device
  synchronized at its end; batch packing excluded) and the step it started
  at (0, or one past the checkpoint it resumed from)."""
  model: torch.nn.Module
  losses: List[float]
  step_seconds: List[float]
  start_step: int = 0


@dataclasses.dataclass
class Setup:
  """Everything a run needs, on its device."""
  model: torch.nn.Module      # the unwrapped GenCast
  statics: object             # its graph statics
  source: object              # the data source
  wrapped: torch.nn.Module    # the wrapper stack that is trained
  optimizer: object           # steps.Optimizer
  batches: object             # iterator of numpy batches
  device: torch.device


def add_model_flags(p: argparse.ArgumentParser) -> None:
  """The flags both CLIs share: preset, data, wrappers, the architecture
  overrides of `build_spec` and the device."""
  p.add_argument('--model', default='gencast',
                 help="'gencast' (graphcast is not ported yet)")
  p.add_argument('--preset', default='nano',
                 help='tiny, nano or 1deg (0.25deg is not ported yet)')
  p.add_argument('--data', default='synthetic',
                 help="'synthetic' (ERA5 directories are not ported yet)")
  p.add_argument('--seed', type=int, default=0)
  # Architecture overrides (None -> preset value).
  p.add_argument('--mesh_size', type=int, default=None)
  p.add_argument('--d_model', type=int, default=None)
  p.add_argument('--num_layers', type=int, default=None)
  p.add_argument('--num_heads', type=int, default=None)
  p.add_argument('--attention_k_hop', type=int, default=None)
  p.add_argument('--attention_type', default=None,
                 help=f'{" or ".join(_ATTENTION_TYPES)} (the reference\'s '
                      'triblock and dense are not ported yet)')
  # Wrappers.
  p.add_argument('--no_normalization', action='store_true',
                 help='skip the InputsAndResiduals wrapper')
  p.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                 default=None,
                 help='bf16 compute with f32 master weights '
                      '(default: the preset decides; --no-bf16 forces f32)')
  p.add_argument('--clean_sst_nans', action='store_true',
                 help='fill the NaNs of sea_surface_temperature (land) '
                      'before the model sees them (NaNCleaner)')
  p.add_argument('--stats_path', default=None,
                 help='npz normalization stats (default: compute from data)')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default: the card, through the kernels) "
                      "or 'cpu' (the kernels' plain versions)")


def later(p: argparse.ArgumentParser, what: str, item: str) -> None:
  """Refuses `what`, naming the ROADMAP.md item that brings it."""
  p.error(f'{what} is not ported yet: ROADMAP.md, "Still to port": {item}')


def check_model_flags(p: argparse.ArgumentParser, args) -> None:
  """Refuses what is not ported, naming the ROADMAP.md item."""
  if args.model != 'gencast':
    later(p, f'--model {args.model}', _LATER_GRAPHCAST)
  if args.preset in _LATER_PRESETS:
    later(p, f'--preset {args.preset}', _LATER_PRESETS[args.preset])
  if args.preset not in _PRESETS:
    p.error(f'unknown --preset {args.preset!r}: {", ".join(_PRESETS)}')
  if args.data != 'synthetic':
    p.error(f'--data {args.data!r}: only synthetic data is ported; ERA5 '
            f'sources come with ROADMAP.md, "Still to port": {_LATER_DATA}')
  if args.attention_type in _LATER_ATTENTION:
    later(p, f'--attention_type {args.attention_type}',
          _LATER_ATTENTION[args.attention_type])
  if args.attention_type not in (None,) + _ATTENTION_TYPES:
    p.error(f'unknown --attention_type {args.attention_type!r}')


def parse_args(argv=None):
  p = argparse.ArgumentParser(
      description='Train GenCast (PyTorch port, CUDA kernels on the card).')
  add_model_flags(p)
  p.add_argument('--steps', type=int, default=30000)
  p.add_argument('--batch_size', type=int, default=1)
  p.add_argument('--learning_rate', type=float, default=3e-4)
  p.add_argument('--warmup_steps', type=int, default=1000)
  p.add_argument('--weight_decay', type=float, default=0.1)
  p.add_argument('--ar_steps', type=int, default=1,
                 help='autoregressive training steps (graphcast only; '
                      'ignored on a GenCast run)')
  p.add_argument('--task', default=None,
                 help='registry task name overriding the preset task (not '
                      'ported yet: GraphCast)')
  p.add_argument('--remat_group', type=int, default=1,
                 help='graphcast only (not ported yet)')
  p.add_argument('--functional_step', action='store_true', default=None,
                 help='not ported: the donated-state step is TPU-only')
  p.add_argument('--steps_per_call', type=int, default=1,
                 help='1 (fused multi-step calls are not ported yet)')
  p.add_argument('--pool_size', type=int, default=64,
                 help='samples resident on the device in fused mode (not '
                      'ported yet, with --steps_per_call)')
  # Checkpointing / eval / logging.
  p.add_argument('--ckpt_dir', default=None,
                 help='save checkpoints here, and resume from the newest')
  p.add_argument('--save_every', type=int, default=500)
  p.add_argument('--eval_every', type=int, default=500)
  p.add_argument('--do_sampling_eval', action='store_true',
                 help='every --eval_every steps, sample one forecast of '
                      'the first window and log its RMSE')
  p.add_argument('--log_every', type=int, default=10)
  p.add_argument('--metrics_jsonl', default=None,
                 help='append one JSON line per log/eval event here')
  p.add_argument('--wandb', action='store_true',
                 help='log metrics to wandb (requires the package; '
                      'falls back to a warning without it)')
  p.add_argument('--wandb_project', default='gencast_tpu')
  p.add_argument('--profile_dir', default=None,
                 help='capture a profiler trace here (not ported yet)')
  p.add_argument('--prefetch', type=int, default=None,
                 help='0 (background prefetch is not ported yet)')
  p.add_argument('--data_workers', type=int, default=0,
                 help='0 (out-of-process packing is not ported yet)')
  # Parallelism and multi-host, the reference's names and defaults.
  p.add_argument('--dp', type=int, default=1)
  p.add_argument('--mp', type=int, default=1)
  p.add_argument('--multihost', action='store_true',
                 help='one process per host (not ported yet)')
  p.add_argument('--coordinator', default=None)
  p.add_argument('--process_id', type=int, default=None)
  p.add_argument('--num_processes', type=int, default=None)
  p.add_argument('--cpu', type=int, default=0, metavar='N',
                 help="not ported: the reference's stand-in of N virtual CPU "
                      'devices is TPU-only (--device cpu runs on the CPU)')
  args = p.parse_args(argv)
  check_model_flags(p, args)
  # --ar_steps is not looked at: AR training is a GraphCast mode, and a
  # stray --ar_steps K on a GenCast run is the reference's no-op.
  for flag in ('functional_step', 'cpu'):
    if getattr(args, flag):
      p.error(f'--{flag} is not ported: TPU-only')
  # (flag, its value, the values that ask for nothing, the ROADMAP.md item)
  for flag, value, off, item in (
      ('task', args.task, (None,), _LATER_GRAPHCAST),
      ('remat_group', args.remat_group, (1,), _LATER_GRAPHCAST),
      ('steps_per_call', args.steps_per_call, (1, 0), _LATER_DATA),
      ('pool_size', args.pool_size, (64,), _LATER_LAUNCHES),
      ('profile_dir', args.profile_dir, (None,), _LATER_DATA),
      ('prefetch', args.prefetch, (None, 0), _LATER_DATA),
      ('data_workers', args.data_workers, (0,), _LATER_DATA),
      ('dp', args.dp, (1,), _LATER_PARALLEL),
      ('mp', args.mp, (1,), _LATER_PARALLEL),
      ('multihost', args.multihost, (False,), _LATER_PARALLEL),
      ('coordinator', args.coordinator, (None,), _LATER_PARALLEL),
      ('process_id', args.process_id, (None,), _LATER_PARALLEL),
      ('num_processes', args.num_processes, (None,), _LATER_PARALLEL)):
    if value not in off:
      later(p, f'--{flag} {value}', item)
  return args


def build_spec(args):
  """The preset's ModelSpec with the architecture overrides applied."""
  from gencast_tpu_torch import configs
  spec = configs.SPECS[args.preset]
  overrides = {}
  if args.mesh_size is not None:
    overrides['mesh_splits'] = args.mesh_size
  for field in ('d_model', 'num_layers', 'num_heads', 'attention_k_hop',
                'attention_type'):
    v = getattr(args, field)
    if v is not None:
      overrides[field] = v
  return dataclasses.replace(spec, **overrides) if overrides else spec


def select_device(name: str) -> torch.device:
  """The device `--device` names; the card must be there when it is asked
  for (no quiet fall-back to the CPU)."""
  device = torch.device(name)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'--device {name}: no CUDA card is available; pass '
                       '--device cpu to run on the CPU')
  return device


def load_or_compute_stats(args, source, task, tag: str, save: bool):
  """Stats from --stats_path when the file exists, else computed from the
  source (and written to --stats_path when `save`)."""
  from gencast_tpu_torch.data import sources
  if args.stats_path and os.path.exists(args.stats_path):
    print(f'[{tag}] loaded stats from {args.stats_path}', flush=True)
    return sources.load_stats_auto(args.stats_path, task.pressure_levels)
  stats = sources.compute_stats(source)
  if save and args.stats_path:
    sources.save_stats(stats, args.stats_path)
    print(f'[{tag}] computed and saved stats to {args.stats_path}',
          flush=True)
  return stats


def build_wrapped(args, spec, model, stats, device, tag: str):
  """The wrapper stack both CLIs build from the same flags (a checkpoint's
  parameter names depend on its nesting), on `device`."""
  from gencast_tpu_torch.models import wrappers
  bf16 = args.bf16 or (args.bf16 is None and spec.cast_bf16)
  if bf16:
    print(f'[{tag}] bf16 compute enabled (f32 master weights)', flush=True)
  return wrappers.build_stack(model, stats, bf16=bf16,
                              clean_sst_nans=args.clean_sst_nans,
                              normalize=not args.no_normalization).to(device)


def step_generator(seed: int, step: int, device) -> torch.Generator:
  """The generator of step `step`'s noise level and noise."""
  from gencast_tpu_torch.models import diffusion_utils
  return diffusion_utils.keyed_generator(seed, step, device=device)


def setup(args) -> Setup:
  """Builds the model, data, stats, wrapper stack and optimizer of a run of
  `args` on the device `args.device` names."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.training import steps as steps_lib

  device = select_device(args.device)
  spec = build_spec(args)
  print(f'[train] spec={spec.name} mesh_splits={spec.mesh_splits} '
        f'd_model={spec.d_model} layers={spec.num_layers} '
        f'attention={spec.attention_type} device={device}', flush=True)
  model, statics = configs.build_gencast(spec, seed=args.seed, device=device)
  task = model.task

  source = sources.SyntheticSource(
      task, np.asarray(statics.grid_lat), np.asarray(statics.grid_lon),
      num_times=max(40, args.batch_size * 8), seed=args.seed)
  print(f'[train] data source: {type(source).__name__}, {len(source)} '
        f'samples', flush=True)
  stats = load_or_compute_stats(args, source, task, 'train', save=True)
  wrapped = build_wrapped(args, spec, model, stats, device, 'train')
  optimizer = steps_lib.create_optimizer(
      wrapped, steps_lib.OptimizerConfig(
          learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
          total_steps=args.steps, weight_decay=args.weight_decay))
  batches = sources.batch_iterator(source, args.batch_size, seed=args.seed)
  return Setup(model=model, statics=statics, source=source, wrapped=wrapped,
               optimizer=optimizer, batches=batches, device=device)


def main(argv=None) -> TrainRun:
  args = parse_args(argv)
  from gencast_tpu_torch.models import casting
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import steps as steps_lib
  from gencast_tpu_torch.training.metrics_sink import MetricsSink
  s = setup(args)
  wrapped, optimizer, device = s.wrapped, s.optimizer, s.device

  start_step = 0
  manager = None
  if args.ckpt_dir:
    manager = ckpt_lib.create_manager(args.ckpt_dir)
    if ckpt_lib.latest_step(manager) is not None:
      start_step = ckpt_lib.restore(manager, wrapped, optimizer) + 1
      print(f'[train] resumed from step {start_step - 1}: continuing at '
            f'step {start_step}', flush=True)

  sink = MetricsSink(args.metrics_jsonl, use_wandb=args.wandb,
                     wandb_project=args.wandb_project,
                     run_config={'preset': args.preset, 'model': args.model,
                                 'steps': args.steps,
                                 'batch_size': args.batch_size,
                                 'lr': args.learning_rate})
  run = TrainRun(model=wrapped, losses=[], step_seconds=[],
                 start_step=start_step)
  losses: List[torch.Tensor] = []
  t_log = time.perf_counter()
  try:
    for step in range(start_step, args.steps):
      batch = {k: torch.as_tensor(v).to(device)
               for k, v in next(s.batches).items()}
      _synchronize(device)
      t0 = time.perf_counter()
      loss, _ = steps_lib.train_step(
          wrapped, optimizer, batch['inputs'], batch['targets'],
          batch['forcings'], step_generator(args.seed, step, device))
      _synchronize(device)
      run.step_seconds.append(time.perf_counter() - t0)
      losses.append(loss)
      if (step + 1) % args.log_every == 0:
        dt = time.perf_counter() - t_log
        mean_loss = float(torch.stack(losses[-args.log_every:]).mean())
        print(f'[train] step {step + 1}/{args.steps} loss={mean_loss:.4f} '
              f'{args.log_every / dt:.2f} steps/s', flush=True)
        sink.log('train', step + 1, loss=mean_loss,
                 steps_per_sec=args.log_every / dt)
        t_log = time.perf_counter()

      if manager is not None and (step + 1) % args.save_every == 0:
        ckpt_lib.save(manager, step, wrapped, optimizer)

      if args.do_sampling_eval and (step + 1) % args.eval_every == 0:
        _sampling_eval(args, s, sink, step)
  finally:
    sink.close()
  run.losses = [float(x) for x in losses]
  if manager is not None and args.steps > start_step:
    ckpt_lib.save(manager, args.steps - 1, wrapped, optimizer)
    print(f'[train] final checkpoint at {args.ckpt_dir}', flush=True)
  casting.refresh_all(wrapped)
  print('[train] done', flush=True)
  return run


def _sampling_eval(args, s: Setup, sink, step: int) -> None:
  """One sampled forecast of the source's first window: its RMSE against
  the target (NaNs skipped), and with a sink on, the triptych image of the
  first target channel."""
  from gencast_tpu_torch import rollout
  from gencast_tpu_torch.models import casting, diffusion_utils
  casting.refresh_all(s.wrapped)  # serve the weights trained so far
  w = s.source.sample(0)
  frc = torch.as_tensor(w.forcings)[None][None].to(s.device)  # [K=1, B=1]
  preds = rollout.sample_rollout(
      s.wrapped, torch.as_tensor(w.inputs)[None].to(s.device), frc,
      diffusion_utils.keyed_generator(args.seed, 10**9 + step,
                                      device=s.device))
  pred = preds[0, 0].cpu().numpy()
  rmse = float(np.sqrt(np.nanmean((pred - w.targets) ** 2)))
  print(f'[train] sampling eval rmse={rmse:.4f}', flush=True)
  sink.log('sampling_eval', step + 1, rmse=rmse)
  if args.metrics_jsonl or args.wandb:
    # The training-time triptych image, as the reference's.
    from gencast_tpu_torch.training import plotting
    d = s.model.denoiser
    var = d.target_layout.var_names[0]
    ch = d.target_layout.var_channels(var)[0]
    img_dir = (os.path.dirname(args.metrics_jsonl) if args.metrics_jsonl
               else (args.ckpt_dir or tempfile.gettempdir()))
    img = os.path.join(img_dir, f'eval_{var}_step{step + 1}.png')
    plotting.plot_triptych(pred[:, :, ch], w.targets[:, :, ch],
                           np.asarray(s.statics.grid_lat),
                           np.asarray(s.statics.grid_lon), var, img)
    sink.log_image('sampling_eval', step + 1, var, img)


def _synchronize(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


if __name__ == '__main__':
  main()
