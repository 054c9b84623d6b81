"""Training CLI (GenCast or GraphCast on synthetic or ERA5 data).

Counterpart of `gencast_tpu.training.train` for the paths the port runs:
GenCast (`--model gencast`, the default) or GraphCast (`--model graphcast`:
the preset's grid, mesh and widths with GraphCast's variables, or the
`--task` given; `--remat_group`; `--ar_steps K` trains the K-step
autoregressive loss) at the TINY, nano, 1-degree and 0.25-degree presets
on the synthetic source
or an ERA5 directory (`--data <dir>`: the monthly NetCDF files when
`era5_pressure_levels_*.nc` are there, else the npz shards of
`tools.convert_era5`), one training step per batch or, with
`--steps_per_call K`, K steps per host call over a device-resident pool of
`--pool_size` samples (on the card each step replays one CUDA graph), on
the CUDA card (the kernels) unless `--device cpu` asks for the CPU (their
plain versions). Flags keep the reference's names, defaults and meanings:
checkpoints with resume (`--ckpt_dir`, `--save_every`), metrics
(`--metrics_jsonl`, `--wandb`), stats (`--stats_path`: an npz file, or a
directory of DeepMind's published NetCDF statistics), the sampling eval
(`--eval_every`, `--do_sampling_eval`), `--no_normalization`, the
architecture overrides, and in the per-step loop the input pipeline
(`--prefetch`: batches copied to the card by a background thread through
pinned memory; `--data_workers`: windows packed in spawned processes; the
batches are bitwise the same either way) and `--profile_dir` (a
torch.profiler trace of steps 10-15, or of `--profile_steps`). Every flag
of the reference's CLI parses; the TPU-only ones (`--functional_step`,
`--cpu`) are refused as such. `--ar_steps K` on a GenCast run is the
reference's no-op; on a GraphCast run its windows of K target frames come from the same
source and pool (`--data_workers` is ignored there, as in the reference).

Data and model parallelism, with the reference's rules: `--multihost`
makes this process one rank of `--num_processes` (`--process_id`, the TCP
store at `--coordinator`, or torchrun's environment; parallel/meshes.py),
`--dp` defaulting to their number and dp * mp equal to it; `--dp N --mp M`
without `--multihost` starts N·M local ranks itself (spawned processes,
rank r on cuda:(r mod cards), or the CPU under `--device cpu`), as the
reference's CLI runs on a host of N·M devices. Each data rank packs only
its rows of the global batch ([r·B/dp, (r+1)·B/dp) of the same
permutation), draws the step's noise level and noise for the global batch
and keeps its rows, and averages the gradient and the loss over the data
axis (training/steps.py) before the clip: the step of the global-batch
mean loss. Along the model axis (`--mp`, parallel/tensor.py) the ranks of
one data coordinate compute one model together, each holding its slices of
the attention heads and MLP hidden widths, and their collectives run
eagerly (the step is not captured into a CUDA graph). Only rank 0 writes
metrics, stats and checkpoints (full tensors, gathered over the model
axis), and every rank restores on resume.

Randomness: step `s` draws its noise level and noise from a generator
seeded from (`--seed`, s) alone, as the reference folds the step into its
key, so a resumed run draws what an uninterrupted one would. As in the
reference, the batch stream is not saved: a resumed run starts it again
from its beginning.

Examples:
  # Smoke-train a tiny model on synthetic data on the CPU:
  python -m gencast_tpu_torch.training.train --preset tiny --steps 3 \
      --data synthetic --device cpu

  # Nano from an ERA5 directory on one H100 (the card's machine has no
  # h5py: write the npz layout, with tools.synth_era5 --layout npz or
  # tools.convert_era5 on a machine with h5py):
  python -m gencast_tpu_torch.tools.synth_era5 --out /path/to/era5_npz \
      --resolution 2.5 --steps_per_month 20 --layout npz
  python -m gencast_tpu_torch.training.train --preset nano --steps 16 \
      --data /path/to/era5_npz --data_workers 2 --profile_dir /path/to/trace

  # GraphCast_small (1 degree, 13 levels, splits 5, latent 512, 16 steps)
  # on one H100, two-step autoregressive loss, 2 steps per host call:
  python -m gencast_tpu_torch.training.train --model graphcast \
      --preset 1deg --data synthetic --steps 4 --ar_steps 2 \
      --steps_per_call 2

  # Two data-parallel ranks on the CPU (gloo), batch 2, one row each:
  python -m gencast_tpu_torch.training.train --preset tiny --device cpu \
      --data synthetic --steps 3 --batch_size 2 --dp 2

  # Two model-parallel ranks (heads and MLP hidden widths split in two);
  # on one H100 drop --device cpu: both ranks share cuda:0 over gloo:
  python -m gencast_tpu_torch.training.train --preset tiny --device cpu \
      --data synthetic --steps 2 --dp 1 --mp 2

  # One rank of a multi-process run (start one command per process):
  python -m gencast_tpu_torch.training.train --preset 1deg --data synthetic \
      --clean_sst_nans --batch_size 2 --multihost --coordinator host:29500 \
      --num_processes 2 --process_id 0

  # Three full-width nano steps on one H100 (the default preset):
  python -m gencast_tpu_torch.training.train --steps 3 --data synthetic

  # Nano on one H100, 8 steps per host call (CUDA-graph replays):
  python -m gencast_tpu_torch.training.train --preset nano --steps_per_call 8

  # Full-width 1-degree steps on one H100 with checkpoints; run it again
  # with a larger --steps to resume from the newest checkpoint:
  python -m gencast_tpu_torch.training.train --preset 1deg --steps 3 \
      --data synthetic --clean_sst_nans --ckpt_dir /path/to/ckpt

  # The paper's 0.25-degree model on one H100 (streamed-edge GNNs, GNN
  # remat, bf16), batch 1; the first run builds and caches the graph
  # statics (configs.DEFAULT_CACHE_DIR):
  python -m gencast_tpu_torch.training.train --preset 0.25deg --steps 3 \
      --data synthetic --clean_sst_nans
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import json
import os
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

# The reference's presets, and TINY on the block-sparse kernels' backend
# (configs.TINY_PALLAS), which the CPU tests run the CLIs on.
_PRESETS = ('tiny', 'tiny_pallas', 'nano', '1deg', '0.25deg')
_MODELS = ('gencast', 'graphcast')
# --profile_dir traces these steps by default, as the reference's.
PROFILE_STEPS = (10, 15)
PROFILE_TRACE = 'train_steps_10-15.pt.trace.json'


@dataclasses.dataclass
class TrainRun:
  """What a run leaves: the trained wrapper stack, the mean loss of every
  step it took, the seconds each step took (host clock, the device
  synchronized at its end; batch packing excluded), the step it started
  at (0, or one past the checkpoint it resumed from) and, in the per-step
  loop, the seconds each step waited for its batch on the device."""
  model: torch.nn.Module
  losses: List[float]
  step_seconds: List[float]
  start_step: int = 0
  batch_seconds: List[float] = dataclasses.field(default_factory=list)


# What the parent of spawned ranks gets back from rank 0 (its TrainRun but
# the model, which stays in the rank's process).
_RUN_FIELDS = ('losses', 'step_seconds', 'start_step', 'batch_seconds')


@dataclasses.dataclass
class Setup:
  """Everything a run needs, on its device."""
  model: torch.nn.Module      # the unwrapped GenCast or GraphCast
  statics: object             # its graph statics
  source: object              # the data source
  source_factory: object      # picklable; builds the source (--data_workers)
  wrapped: torch.nn.Module    # the wrapper stack that is trained
  optimizer: object           # steps.Optimizer
  batches: object             # iterator of numpy batches
  device: torch.device
  ar_steps: int = 1           # target frames per window (GraphCast AR)
  mesh: object = None         # parallel.meshes.Mesh of a multi-rank run
  rows: Optional[Tuple[int, int]] = None  # [lo, hi): this rank's batch rows

  @property
  def is_main(self) -> bool:
    """Rank 0 (or the only process): writes metrics and checkpoints."""
    return self.mesh is None or self.mesh.rank == 0

  @property
  def rank_note(self) -> str:
    """' (rank r of n)' on a rank of a multi-process run, for its
    per-process lines; '' otherwise."""
    return ('' if self.mesh is None else
            f' (rank {self.mesh.rank} of {self.mesh.size})')


def add_model_flags(p: argparse.ArgumentParser) -> None:
  """The flags both CLIs share: preset, data, wrappers, the architecture
  overrides of `build_spec` and the device."""
  p.add_argument('--model', default='gencast',
                 help="'gencast' or 'graphcast'")
  p.add_argument('--task', default=None,
                 help='registry task name overriding the preset task '
                      '(e.g. graphcast_37 for the full published '
                      '37-level GraphCast configuration)')
  p.add_argument('--preset', default='nano',
                 help='tiny, nano, 1deg or 0.25deg (or tiny_pallas: TINY on '
                      'the block-sparse backend)')
  p.add_argument('--data', default='synthetic',
                 help="'synthetic' or a directory of ERA5 data: monthly "
                      'NetCDF files (era5_pressure_levels_*.nc; h5py) or '
                      'the npz shards of tools.convert_era5 (numpy only)')
  p.add_argument('--seed', type=int, default=0)
  # Architecture overrides (None -> preset value).
  p.add_argument('--mesh_size', type=int, default=None)
  p.add_argument('--d_model', type=int, default=None)
  p.add_argument('--num_layers', type=int, default=None)
  p.add_argument('--num_heads', type=int, default=None)
  p.add_argument('--attention_k_hop', type=int, default=None)
  p.add_argument('--attention_type', default=None,
                 help='pallas (block-sparse, kernels A and F), '
                      'triblock_pallas (tri-block, kernels C and D), or the '
                      'reference\'s einsum triblock and dense (plain '
                      'PyTorch)')
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
                 help='npz normalization stats, or a directory of '
                      "DeepMind's published NetCDF stats (default: compute "
                      'from data)')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default: the card, through the kernels) "
                      "or 'cpu' (the kernels' plain versions)")


def check_model_flags(p: argparse.ArgumentParser, args) -> None:
  """Refuses an unknown model, task, preset or attention backend."""
  from gencast_tpu_torch.data import registry
  if args.model not in _MODELS:
    p.error(f'unknown --model {args.model!r}: {", ".join(_MODELS)}')
  if args.task is not None and args.task not in registry.TASKS:
    p.error(f'unknown --task {args.task!r}: {", ".join(registry.TASKS)}')
  if args.preset not in _PRESETS:
    p.error(f'unknown --preset {args.preset!r}: {", ".join(_PRESETS)}')
  from gencast_tpu_torch.nn.transformer import ATTENTION_TYPES
  if args.attention_type not in (None,) + ATTENTION_TYPES:
    p.error(f'unknown --attention_type {args.attention_type!r}: '
            f'{", ".join(ATTENTION_TYPES)}')


def parse_args(argv=None):
  p = argparse.ArgumentParser(
      description='Train GenCast or GraphCast (PyTorch port, CUDA kernels '
                  'on the card).')
  add_model_flags(p)
  p.add_argument('--steps', type=int, default=30000)
  p.add_argument('--batch_size', type=int, default=1)
  p.add_argument('--learning_rate', type=float, default=3e-4)
  p.add_argument('--warmup_steps', type=int, default=1000)
  p.add_argument('--weight_decay', type=float, default=0.1)
  p.add_argument('--ar_steps', type=int, default=1,
                 help='autoregressive training steps (graphcast only; '
                      'ignored on a GenCast run)')
  p.add_argument('--remat_group', type=int, default=1,
                 help='graphcast only: nested-checkpoint group size for '
                      'the processor steps (hierarchical remat; implies '
                      'remat when > 1)')
  p.add_argument('--functional_step', action='store_true', default=None,
                 help='not ported: the donated-state step is TPU-only')
  p.add_argument('--steps_per_call', type=int, default=1,
                 help='K > 1 runs K training steps per host call over a '
                      'device-resident sample pool (on the card, K replays '
                      'of one CUDA graph of the step; batch_size 1)')
  p.add_argument('--pool_size', type=int, default=64,
                 help='max samples resident on the device in fused mode; '
                      'a sample is lat x lon x (inputs + targets + '
                      'forcings) channels x 4 bytes: 10.9 MB at nano, '
                      '69 MB at 1deg, 1.1 GB at 0.25deg (176 + 84 + 4 '
                      'channels on 721 x 1440 points)')
  # Checkpointing / eval / logging.
  p.add_argument('--ckpt_dir', default=None,
                 help='save checkpoints here, and resume from the newest')
  p.add_argument('--save_every', type=int, default=500)
  p.add_argument('--eval_every', type=int, default=500)
  p.add_argument('--do_sampling_eval', action='store_true',
                 help='every --eval_every steps, sample one forecast of '
                      'the first window and log its RMSE (per-step mode '
                      'only, as in the reference)')
  p.add_argument('--log_every', type=int, default=10)
  p.add_argument('--metrics_jsonl', default=None,
                 help='append one JSON line per log/eval event here')
  p.add_argument('--wandb', action='store_true',
                 help='log metrics to wandb (requires the package; '
                      'falls back to a warning without it)')
  p.add_argument('--wandb_project', default='gencast_tpu')
  p.add_argument('--profile_dir', default=None,
                 help='write a torch.profiler trace of steps 10-15 here '
                      f'({PROFILE_TRACE}; per-step mode)')
  p.add_argument('--profile_steps', type=int, nargs=2,
                 default=list(PROFILE_STEPS), metavar=('FIRST', 'LAST'),
                 help='the steps --profile_dir traces, first and last '
                      '(0-based; the trace is train_steps_FIRST-LAST'
                      '.pt.trace.json)')
  p.add_argument('--prefetch', type=int, default=None,
                 help='batches kept in flight by the background '
                      'host->device pipeline (data/prefetch.py: pinned '
                      'host memory, copies on a side stream); 0 disables. '
                      'Default: 2 on hosts with more than 2 CPUs, else 0 '
                      '(per-step mode)')
  p.add_argument('--data_workers', type=int, default=0,
                 help='out-of-process batch-packing workers '
                      "(data/workers.py, 'spawn' processes); 0 packs "
                      'in-process. The batches are bitwise the same '
                      'either way (per-step mode)')
  # Parallelism and multi-host, the reference's names and defaults.
  p.add_argument('--dp', type=int, default=1,
                 help='data-parallel ranks; without --multihost, N > 1 '
                      'starts N local ranks')
  p.add_argument('--mp', type=int, default=1,
                 help='model-parallel ranks (tensor parallelism over '
                      'attention heads and MLP hidden widths); without '
                      '--multihost, dp * mp > 1 starts dp * mp local ranks')
  p.add_argument('--multihost', action='store_true',
                 help='this process is one rank of --num_processes '
                      '(torch.distributed over a TCP store at --coordinator, '
                      "or torchrun's environment); --dp defaults to their "
                      'number')
  p.add_argument('--coordinator', default=None)
  p.add_argument('--process_id', type=int, default=None)
  p.add_argument('--num_processes', type=int, default=None)
  p.add_argument('--cpu', type=int, default=0, metavar='N',
                 help="not ported: the reference's stand-in of N virtual CPU "
                      'devices is TPU-only (--device cpu runs on the CPU)')
  args = p.parse_args(argv)
  check_model_flags(p, args)
  if args.pool_size < 1:
    p.error(f'--pool_size must be positive, got {args.pool_size}')
  # AR training is a GraphCast mode: a stray --ar_steps K on a GenCast run
  # is the reference's no-op (`ar_steps`).
  if args.ar_steps < 1:
    p.error(f'--ar_steps must be positive, got {args.ar_steps}')
  for flag in ('functional_step', 'cpu'):
    if getattr(args, flag):
      p.error(f'--{flag} is not ported: TPU-only')
  for flag in ('dp', 'mp'):
    if getattr(args, flag) < 1:
      p.error(f'--{flag} must be positive, got {getattr(args, flag)}')
  return args


def build_spec(args):
  """The preset's ModelSpec with the architecture overrides applied."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import registry
  spec = configs.SPECS[args.preset]
  overrides = {}
  if args.task:
    overrides['task'] = registry.TASKS[args.task]
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


def era5_source_factory(path: str, task, resolution_deg: float):
  """A picklable factory of the ERA5 source of directory `path`: the
  monthly NetCDF files when there are any (h5py), else the npz shards."""
  from gencast_tpu_torch.data import sources
  if glob.glob(os.path.join(path, 'era5_pressure_levels_*.nc')):
    from gencast_tpu_torch.data import era5_netcdf
    return functools.partial(era5_netcdf.Era5NetCDFSource, path, task,
                             resolution_deg=resolution_deg)
  return functools.partial(sources.Era5NpzSource, path, task)


def require_frames(source, needed: int, data: str, what: str) -> None:
  """Exits with a message naming the frames found and needed when `source`
  holds fewer frames than `what` needs."""
  found = len(source.timestamps())
  if found < needed:
    raise SystemExit(f'--data {data}: {found} frames found; {what} needs '
                     f'{needed} consecutive 12-hour frames')


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


def build_model(args, spec, device):
  """The unwrapped model `--model` names and its graph statics."""
  from gencast_tpu_torch import configs
  if args.model == 'graphcast':
    return configs.build_graphcast(
        spec, seed=args.seed, device=device,
        remat_group=getattr(args, 'remat_group', 1))
  return configs.build_gencast(spec, seed=args.seed, device=device)


def ar_steps(args) -> int:
  """Target frames per training window: --ar_steps on a GraphCast run, 1
  on a GenCast run (where --ar_steps is the reference's no-op)."""
  return args.ar_steps if args.model == 'graphcast' else 1


def ar_batches(source, k: int, seed: int):
  """The reference's AR iterator: windows of k target frames, in
  permutations (from one numpy generator of `seed`) of the
  len(source) - k + 1 starts that hold them; batch 1, targets and forcings
  [k, 1, lat, lon, C]."""
  rng = np.random.default_rng(seed)
  n = len(source) - k + 1
  while True:
    for i in rng.permutation(n):
      w = source.sample(int(i), num_target_frames=k)
      yield {'inputs': w.inputs[None],
             'targets': np.swapaxes(w.targets[None], 0, 1),
             'forcings': np.swapaxes(w.forcings[None], 0, 1)}


def setup(args, mesh=None) -> Setup:
  """Builds the model, data, stats, wrapper stack and optimizer of a run of
  `args` on the device `args.device` names; on a `mesh` of more than one
  data rank, the batches hold this rank's rows and the optimizer averages
  the gradients over the data axis; with a model axis, the model keeps
  this rank's slices (`shard_model`)."""
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.training import steps as steps_lib

  device = select_device(args.device)
  spec = build_spec(args)
  print(f'[train] model={args.model} spec={spec.name} '
        f'mesh_splits={spec.mesh_splits} d_model={spec.d_model} '
        f'layers={spec.num_layers} attention={spec.attention_type} '
        f'device={device}', flush=True)
  model, statics = build_model(args, spec, device)
  task = model.task  # GraphCast's variables where --model graphcast

  # source_factory is the picklable recipe --data_workers ships to its
  # packing processes (each builds its own source).
  if args.data == 'synthetic':
    source_factory = functools.partial(
        sources.SyntheticSource, task, np.asarray(statics.grid_lat),
        np.asarray(statics.grid_lon), num_times=max(40, args.batch_size * 8),
        seed=args.seed)
  else:
    source_factory = era5_source_factory(args.data, task, spec.resolution_deg)
  source = source_factory()
  # Computed forcings (TISR) on the run's device; packing processes
  # (--data_workers) build their own sources and compute them on the CPU.
  source.forcing_device = device
  k = ar_steps(args)
  require_frames(source, task.num_input_frames + 1, args.data,
                 f'a training window ({task.num_input_frames} input frames '
                 'and a target)')
  if len(source) - k + 1 <= 0:
    raise SystemExit(f'--data {args.data}: the source holds '
                     f'{len(source)} windows, too short for --ar_steps {k} '
                     f'({task.num_input_frames} input frames and {k} '
                     'targets)')
  print(f'[train] data source: {type(source).__name__}, {len(source)} '
        f'samples', flush=True)
  main_rank = mesh is None or mesh.rank == 0
  stats = load_or_compute_stats(args, source, task, 'train', save=main_rank)
  wrapped = build_wrapped(args, spec, model, stats, device, 'train')
  shard(wrapped, mesh, 'train')
  rows = None
  if mesh is not None and mesh.axis_size('data') > 1:
    from gencast_tpu_torch.parallel import meshes
    rows = meshes.data_rows(mesh, args.batch_size)
    print(f'[train] multihost input sharding: this process packs '
          f'{rows[1] - rows[0]}/{args.batch_size} batch rows', flush=True)
  optimizer = steps_lib.create_optimizer(
      wrapped, steps_lib.OptimizerConfig(
          learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
          total_steps=args.steps, weight_decay=args.weight_decay),
      data_group=mesh.group('data') if rows is not None else None)
  batches = (ar_batches(source, k, args.seed) if k > 1 else
             sources.batch_iterator(source, args.batch_size, seed=args.seed,
                                    rows=None if rows is None
                                    else np.arange(*rows)))
  return Setup(model=model, statics=statics, source=source,
               source_factory=source_factory, wrapped=wrapped,
               optimizer=optimizer, batches=batches, device=device,
               ar_steps=k, mesh=mesh, rows=rows)


def shard(wrapped, mesh, tag: str) -> None:
  """Under a mesh with a model axis: keeps this rank's slices of `wrapped`
  (parallel/tensor.py), remakes its bf16 serving copy, and says what was
  sharded and that the collectives run eagerly."""
  from gencast_tpu_torch.models import casting
  from gencast_tpu_torch.parallel import tensor
  axis = tensor.axis_of(mesh)
  if axis is None:
    return
  sharded, whole = tensor.shard_model(wrapped, axis)
  casting.refresh_all(wrapped)
  if mesh.rank == 0:
    print(f'[{tag}] model axis {axis.size}: {len(sharded)} modules sharded '
          f'(attention heads, MLP hidden widths); stayed whole: '
          f'{whole or "none"}', flush=True)
    print(f'[{tag}] model axis: the training step and the sampler run '
          'eagerly (their all_reduces are not captured into CUDA graphs)',
          flush=True)


def start_rank(args):
  """Under --multihost: joins the process group (parallel/meshes.py;
  args.device becomes this rank's device) and applies the reference's
  rules: --dp defaults to the number of ranks and dp * mp must equal it,
  then `check_ranks`; no sampling eval.
  Returns the rank's Mesh over (1, dp, mp); None without --multihost."""
  if not args.multihost:
    return None
  import torch.distributed as dist
  from gencast_tpu_torch.parallel import meshes
  backend, device = meshes.initialize(args.coordinator, args.num_processes,
                                      args.process_id, device=args.device)
  world, rank = dist.get_world_size(), dist.get_rank()
  args.device = str(device)
  print(f'[train] multihost: process {rank}/{world}, backend {backend}, '
        f'device {device}', flush=True)
  if args.dp * args.mp == 1:
    args.dp = world
    print(f'[train] multihost: defaulting --dp to {args.dp}', flush=True)
  if args.dp * args.mp != world:
    raise SystemExit(f'[train] --multihost needs dp*mp == the number of '
                     f'ranks ({world}), got {args.dp}x{args.mp}')
  check_ranks(args)
  if args.do_sampling_eval:
    print('[train] WARNING: --do_sampling_eval is disabled under '
          '--multihost', flush=True)
    args.do_sampling_eval = False
  mesh = meshes.make_mesh(1, args.dp, args.mp)
  print(f'[train] mesh: data={args.dp} model={args.mp}', flush=True)
  return mesh


def check_ranks(args) -> None:
  """The reference's rules for a run of several ranks: the batch splits
  evenly over dp, and --ar_steps > 1 only on one host with dp 1 (every
  rank of a model axis holds the whole [K, B, ...] window; a data axis
  cannot split it, and --multihost refuses it as the reference does)."""
  if args.batch_size % args.dp:
    raise SystemExit(f'[train] batch_size ({args.batch_size}) must be '
                     f'divisible by dp ({args.dp})')
  multihost = args.multihost and not getattr(args, 'local_rank', False)
  if ar_steps(args) > 1 and (args.dp > 1 or multihost):
    raise SystemExit('[train] --ar_steps > 1 is not supported under '
                     '--multihost or with dp > 1; train AR on one host '
                     'with dp=1')


def _local_rank(rank: int, world: int, coordinator: str, argv: List[str],
                result: str) -> None:
  """One of the ranks `--dp N --mp M` starts: this CLI under --multihost;
  rank 0 writes its run's numbers to `result` for the parent."""
  run = main(argv + ['--multihost', '--coordinator', coordinator,
                     '--process_id', str(rank), '--num_processes',
                     str(world)], local_rank=True)
  if rank == 0:
    with open(result, 'w') as f:
      json.dump({k: getattr(run, k) for k in _RUN_FIELDS}, f)


def spawn_local_ranks(args, argv: List[str]) -> TrainRun:
  """`--dp N --mp M` without --multihost: N·M local ranks of this command
  (spawned processes over a localhost store), waited for. Returns rank 0's
  TrainRun, without the model (it stays in the rank's process; its
  checkpoints hold the parameters)."""
  from gencast_tpu_torch.parallel import meshes
  check_ranks(args)
  world = args.dp * args.mp
  print(f'[train] --dp {args.dp} --mp {args.mp}: starting {world} local '
        'ranks', flush=True)
  with tempfile.TemporaryDirectory() as tmp:
    result = os.path.join(tmp, 'rank0.json')
    meshes.spawn(_local_rank, world, (argv, result))
    with open(result) as f:
      numbers = json.load(f)
  print('[train] done', flush=True)
  return TrainRun(model=None, **numbers)


def main(argv=None, *, local_rank: bool = False) -> TrainRun:
  """The CLI; `local_rank` marks one of the ranks that `--dp N --mp M`
  starts on this host (spawn_local_ranks), not a --multihost process."""
  argv = list(sys.argv[1:] if argv is None else argv)
  args = parse_args(argv)
  args.local_rank = local_rank
  if args.dp * args.mp > 1 and not args.multihost:
    return spawn_local_ranks(args, argv)
  try:
    return _train(args)
  finally:
    if args.multihost:
      from gencast_tpu_torch.parallel import meshes
      meshes.shutdown()


def _train(args) -> TrainRun:
  from gencast_tpu_torch.models import casting
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training.metrics_sink import MetricsSink
  s = setup(args, start_rank(args))
  wrapped, optimizer = s.wrapped, s.optimizer

  start_step = 0
  manager = None
  if args.ckpt_dir:
    manager = ckpt_lib.create_manager(args.ckpt_dir)
    if ckpt_lib.latest_step(manager) is not None:
      start_step = ckpt_lib.restore(manager, wrapped, optimizer) + 1
      print(f'[train] resumed from step {start_step - 1}: continuing at '
            f'step {start_step}', flush=True)

  # Host-side sinks write from rank 0 only (every rank has the same
  # averaged loss).
  if not s.is_main:
    args.metrics_jsonl, args.wandb = None, False
  sink = MetricsSink(args.metrics_jsonl, use_wandb=args.wandb,
                     wandb_project=args.wandb_project,
                     run_config={'preset': args.preset, 'model': args.model,
                                 'steps': args.steps,
                                 'batch_size': args.batch_size,
                                 'lr': args.learning_rate})
  run = TrainRun(model=wrapped, losses=[], step_seconds=[],
                 start_step=start_step)
  # Fused multi-step training: K steps per host call (see
  # steps_lib.scanned_train_steps), batch 1 only, as the reference's.
  fused = (args.steps_per_call > 1 and args.batch_size == 1
           and s.mesh is None)
  if args.steps_per_call > 1 and not fused:
    print('[train] fused steps_per_call requires batch_size=1 and no '
          'mesh; falling back to per-step dispatch', flush=True)
  if args.data_workers > 0 and (fused or s.ar_steps > 1):
    # Neither the fused loop's device pool nor the AR windows go through
    # the packing workers, as in the reference.
    mode = 'fused steps_per_call' if fused else 'AR (ar_steps > 1)'
    print(f'[train] --data_workers is ignored in {mode} mode; batches are '
          'packed in-process', flush=True)
  try:
    if fused:
      _run_fused(args, s, manager, sink, run)
    else:
      _run_per_step(args, s, manager, sink, run)
  finally:
    sink.close()
  if manager is not None and args.steps > start_step:
    # Every rank: a model axis gathers the full tensors; rank 0 writes.
    ckpt_lib.save(manager, args.steps - 1, wrapped, optimizer,
                  write=s.is_main)
    if s.is_main:
      print(f'[train] final checkpoint at {args.ckpt_dir}', flush=True)
  casting.refresh_all(wrapped)
  if s.device.type == 'cuda':
    from gencast_tpu_torch.ops import cuda_lib
    # One write per line: ranks may share a stdout.
    print(f'[train] kernel launches in this process{s.rank_note} '
          + json.dumps({c.name: c.launches for c in cuda_lib.COUNTERS})
          + '\n', end='', flush=True)
  print('[train] done', flush=True)
  return run


def default_prefetch(prefetch) -> int:
  """--prefetch, or when not given the reference's default: 2 on hosts
  with more than 2 CPUs, else 0."""
  if prefetch is not None:
    return prefetch
  return 2 if (os.cpu_count() or 1) > 2 else 0


def step_draws(args, s: Setup, step: int) -> dict:
  """The random draws of training step `step`, as train_step's keyword
  arguments: the generator of (--seed, step); on one of several data ranks,
  the noise level and noise that generator draws for the global batch,
  cut to this rank's rows, so the ranks together draw what one process of
  the global batch draws."""
  from gencast_tpu_torch.training import steps as steps_lib
  generator = step_generator(args.seed, step, s.device)
  owner = steps_lib.draws_owner(s.wrapped)
  if s.rows is None or owner is None:
    return {'generator': generator}
  sigma, noise = owner.training_draws(generator, args.batch_size)
  lo, hi = s.rows
  return {'sigma': sigma[lo:hi], 'noise': noise[lo:hi]}


def _run_per_step(args, s: Setup, manager, sink, run: TrainRun) -> None:
  """One training step per host call from the batch stream (in-process or
  --data_workers processes, through --prefetch's thread), with the logs,
  checkpoints, sampling evals and profile `args` asks for; fills `run`."""
  from gencast_tpu_torch import utils
  from gencast_tpu_torch.data import prefetch as prefetch_lib
  from gencast_tpu_torch.parallel import tensor
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import steps as steps_lib
  wrapped, optimizer, device = s.wrapped, s.optimizer, s.device
  packer = prefetcher = prof = None
  losses: List[torch.Tensor] = []
  # The model axis's all_reduce counters (parallel/tensor.py) before the
  # last step, when the model is sharded.
  axis = tensor.model_axis(wrapped)
  traffic = None
  try:
    started = time.perf_counter()
    if args.data_workers > 0 and s.ar_steps == 1:
      from gencast_tpu_torch.data import workers as workers_lib
      it = packer = workers_lib.ParallelBatchIterator(
          s.source_factory, args.batch_size, num_workers=args.data_workers,
          seed=args.seed, rows=None if s.rows is None else np.arange(*s.rows))
      print(f'[train] packing batches in {args.data_workers} worker '
            f'processes (started in {time.perf_counter() - started:.2f} s)',
            flush=True)
    else:
      it = s.batches
    put = prefetch_lib.CardCopy(device)
    n_prefetch = default_prefetch(args.prefetch)
    if n_prefetch > 0:
      # Background host packing + device copy (the Grain role): the step
      # loop consumes batches already on the device.
      it = prefetcher = prefetch_lib.DevicePrefetcher(it, transform=put,
                                                      buffer_size=n_prefetch)
      get_batch = lambda: prefetch_lib.arrived(next(it))  # noqa: E731
    else:
      get_batch = lambda: prefetch_lib.arrived(put(next(it)))  # noqa: E731

    t_log = time.perf_counter()
    for step in range(run.start_step, args.steps):
      if args.profile_dir and step == args.profile_steps[0]:
        prof = utils.start_profiler(device.type == 'cuda')
      t_wait = time.perf_counter()
      batch = get_batch()
      _synchronize(device)
      t0 = time.perf_counter()
      run.batch_seconds.append(t0 - t_wait)
      if axis is not None and step == args.steps - 1:
        traffic = dict(axis.traffic)
      if s.ar_steps > 1:
        loss, _ = steps_lib.ar_train_step(
            wrapped, optimizer, batch['inputs'], batch['targets'],
            batch['forcings'], keys=(args.seed, step))
      else:
        loss, _ = steps_lib.train_step(
            wrapped, optimizer, batch['inputs'], batch['targets'],
            batch['forcings'], **step_draws(args, s, step))
      _synchronize(device)
      run.step_seconds.append(time.perf_counter() - t0)
      losses.append(loss)
      if prof is not None and step == args.profile_steps[1]:
        _stop_profiler(prof, args, s.mesh)
        prof = None
      if (step + 1) % args.log_every == 0:
        dt = time.perf_counter() - t_log
        mean_loss = float(torch.stack(losses[-args.log_every:]).mean())
        print(f'[train] step {step + 1}/{args.steps} loss={mean_loss:.4f} '
              f'{args.log_every / dt:.2f} steps/s', flush=True)
        sink.log('train', step + 1, loss=mean_loss,
                 steps_per_sec=args.log_every / dt)
        t_log = time.perf_counter()

      if manager is not None and (step + 1) % args.save_every == 0:
        ckpt_lib.save(manager, step, wrapped, optimizer, write=s.is_main)

      if args.do_sampling_eval and (step + 1) % args.eval_every == 0:
        _sampling_eval(args, s, sink, step)
  finally:
    if prof is not None:  # the run ended inside the profiled steps
      _stop_profiler(prof, args, s.mesh)
    if prefetcher is not None:
      prefetcher.close()
    if packer is not None:
      packer.close()
  run.losses = [float(x) for x in losses]
  summary = pipeline_summary(n_prefetch, args.data_workers, run)
  if device.type == 'cuda':
    summary['peak_memory_gib'] = (torch.cuda.max_memory_allocated(device)
                                  / 2**30)
  if traffic is not None:
    # The calls and float32 bytes of the last step's all_reduces.
    summary['model_axis_all_reduce'] = {
        k: axis.traffic[k] - traffic[k] for k in traffic}
  print(f'[train] pipeline{s.rank_note} ' + json.dumps(summary) + '\n',
        end='', flush=True)


def pipeline_summary(prefetch: int, data_workers: int, run: TrainRun) -> dict:
  """The input pipeline's settings and, for the batch wait and the step,
  the first step's seconds (kernel builds, warm-up) and the mean and
  largest over the later steps."""
  summary = {'prefetch': prefetch, 'data_workers': data_workers,
             'steps': len(run.step_seconds)}
  for name, seconds in (('batch_wait_s', run.batch_seconds),
                        ('step_s', run.step_seconds)):
    if seconds:
      rest = seconds[1:] or seconds
      summary[name] = {'first': seconds[0], 'mean': float(np.mean(rest)),
                       'max': max(rest)}
  return summary


def profile_trace_name(mesh=None, steps=PROFILE_STEPS) -> str:
  """The trace file's name for the profiled `steps` (first, last):
  train_steps_<first>-<last>.pt.trace.json (PROFILE_TRACE by default), on a
  rank of a multi-rank run with .rank<r> before .pt."""
  rank = '' if mesh is None else f'.rank{mesh.rank}'
  return f'train_steps_{steps[0]}-{steps[1]}{rank}.pt.trace.json'


def _stop_profiler(prof, args, mesh=None) -> None:
  """Stops `prof` and writes its Chrome trace under args.profile_dir."""
  from gencast_tpu_torch import utils
  path = os.path.join(args.profile_dir,
                      profile_trace_name(mesh, args.profile_steps))
  utils.stop_profiler(prof, path)
  print(f'[train] profiler trace written to {path}', flush=True)


def device_pool(source, size: int, device, ar_steps: int = 1) -> dict:
  """The first `size` samples of `source` as [M, B=1, lat, lon, C] float32
  tensors on `device` ('inputs', 'targets', 'forcings'), copied one sample
  at a time; with ar_steps K > 1, windows of K target frames, whose
  targets and forcings are [M, K, B=1, lat, lon, C]."""
  pool = {}
  for i in range(size):
    w = source.sample(i, num_target_frames=ar_steps)
    for name in ('inputs', 'targets', 'forcings'):
      x = torch.as_tensor(np.asarray(getattr(w, name), np.float32))
      if ar_steps > 1 and name != 'inputs':
        x = x[:, None]  # [K, B=1, ...]
      else:
        x = x[None]
      if name not in pool:
        pool[name] = torch.empty((size,) + tuple(x.shape),
                                 dtype=torch.float32, device=device)
      pool[name][i].copy_(x)
  return pool


def _run_fused(args, s: Setup, manager, sink, run: TrainRun) -> None:
  """K = --steps_per_call training steps per host call over a device pool
  of the first --pool_size samples: the counterpart of the reference's
  `_run_fused`. Its pool rows come from the reference's stream (one
  numpy generator of --seed, extended by a permutation of the pool at a
  time) and step s draws from the generator of (--seed, s), as the
  per-step loop. With --ar_steps K on a GraphCast run the pool holds
  windows of K target frames (the len(source) - K + 1 starts that hold
  them) and each step trains the autoregressive loss. Logs and
  checkpoints where --log_every / --save_every are crossed (saving the last
  step taken); --do_sampling_eval is not run here, as in the reference.
  Fills `run` (each call's seconds shared out over its steps)."""
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import steps as steps_lib
  k_call = args.steps_per_call
  ar = s.ar_steps > 1
  m_pool = min(len(s.source) - s.ar_steps + 1, args.pool_size)
  pool = device_pool(s.source, m_pool, s.device, s.ar_steps)
  fused_fn = steps_lib.scanned_train_steps(s.wrapped, s.optimizer, ar=ar)
  print(f'[train] fused mode: {k_call} steps/call, device pool of {m_pool} '
        'samples' + (f', AR loss over {s.ar_steps} steps' if ar else ''),
        flush=True)

  rng = np.random.default_rng(args.seed)
  perm: List[int] = []
  losses_acc: List[torch.Tensor] = []
  steps_acc = 0
  t_log = time.perf_counter()
  step = run.start_step

  def crossed(every, lo, hi):
    return (hi // every) != (lo // every)

  while step < args.steps:
    k = min(k_call, args.steps - step)
    while len(perm) < k:
      perm.extend(rng.permutation(m_pool).tolist())
    idx, perm = perm[:k], perm[k:]
    _synchronize(s.device)
    t0 = time.perf_counter()
    losses = fused_fn(pool, idx, range(step, step + k), args.seed)
    _synchronize(s.device)
    run.step_seconds.extend([(time.perf_counter() - t0) / k] * k)
    run.losses.extend(float(x) for x in losses.cpu())
    losses_acc.append(losses)
    steps_acc += k
    prev, step = step, step + k

    if crossed(args.log_every, prev, step):
      dt = time.perf_counter() - t_log
      mean_loss = float(torch.cat(losses_acc).mean())
      print(f'[train] step {step}/{args.steps} loss={mean_loss:.4f} '
            f'{steps_acc / dt:.2f} steps/s', flush=True)
      sink.log('train', step, loss=mean_loss, steps_per_sec=steps_acc / dt)
      losses_acc, steps_acc, t_log = [], 0, time.perf_counter()

    if manager is not None and s.is_main and crossed(args.save_every, prev,
                                                     step):
      ckpt_lib.save(manager, step - 1, s.wrapped, s.optimizer)


def _sampling_eval(args, s: Setup, sink, step: int) -> None:
  """One forecast of the source's first window (sampled by GenCast,
  predicted by GraphCast): its RMSE against the target (NaNs skipped), and
  with a sink on, the triptych image of the first target channel."""
  from gencast_tpu_torch import rollout
  from gencast_tpu_torch.models import casting, diffusion_utils, wrappers
  casting.refresh_all(s.wrapped)  # serve the weights trained so far
  w = s.source.sample(0)
  frc = torch.as_tensor(w.forcings)[None][None].to(s.device)  # [K=1, B=1]
  inputs = torch.as_tensor(w.inputs)[None].to(s.device)
  if args.model == 'graphcast':
    preds = rollout.predict_rollout(s.wrapped, inputs, frc)
  else:
    preds = rollout.sample_rollout(
        s.wrapped, inputs, frc,
        diffusion_utils.keyed_generator(args.seed, 10**9 + step,
                                        device=s.device))
  pred = preds[0, 0].cpu().numpy()
  rmse = float(np.sqrt(np.nanmean((pred - w.targets) ** 2)))
  print(f'[train] sampling eval rmse={rmse:.4f}', flush=True)
  sink.log('sampling_eval', step + 1, rmse=rmse)
  if args.metrics_jsonl or args.wandb:
    # The training-time triptych image, as the reference's.
    from gencast_tpu_torch.training import plotting
    d = wrappers.find_layout_provider(s.model)
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
