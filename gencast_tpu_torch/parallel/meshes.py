"""Ranks over (ensemble, data, model), their process groups, and batch rows.

Counterpart of `gencast_tpu.parallel.meshes` over `torch.distributed`: one
process per rank, and a rank is the port's counterpart of a JAX device on
the mesh. The ranks form a grid of shape (ensemble, data, model) in rank
order, as the reference's mesh over the devices in order, with one process
group per axis (the ranks that differ only along it).

- `initialize` starts the process group over a TCP store (the
  coordinator's address, or torchrun's MASTER_ADDR, MASTER_PORT, RANK and
  WORLD_SIZE). The backend is NCCL when every rank has a card of its own,
  and gloo when ranks share a card or run on the CPU: NCCL refuses two ranks
  on one GPU. Gloo on CUDA tensors has only `broadcast` and `all_reduce`,
  so the port's collectives use only `all_reduce` (training/steps.py,
  parallel/ensemble.py).
- `spawn` starts N local ranks ('spawn' processes, a localhost store): one
  command then runs as the reference's CLI does on a host with N devices.
- `local_batch_plan` and `assemble_local_batch`: the rows rank r packs,
  [r·B/dp, (r+1)·B/dp) of its data coordinate, and its local batch.

The model axis is tensor parallelism (--mp): the ranks of one model group
(same ensemble and data coordinates) compute one model together, each
holding its slices of the attention heads and MLP hidden widths
(`parallel.tensor`: `axis_of(mesh)` is the group's `ModelAxis`,
`shard_model` keeps a rank's slices, `gather_state_dict` and
`shard_state_dict` move between them and the full tensors of a
checkpoint). Along the data and ensemble axes parameters are replicated.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ('ensemble', 'data', 'model')
# How long a collective may wait for the other ranks.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
  """This rank's place on the (ensemble, data, model) grid of ranks, and
  the process group of each axis (None for an axis of size 1, or when the
  grid is one rank)."""
  shape: Tuple[int, int, int]
  rank: int = 0
  groups: Dict[str, Optional[object]] = dataclasses.field(
      default_factory=dict)

  @property
  def size(self) -> int:
    return int(np.prod(self.shape))

  @property
  def coords(self) -> Dict[str, int]:
    """This rank's coordinate along each axis."""
    return {axis: int(i) for axis, i in
            zip(AXES, np.unravel_index(self.rank, self.shape))}

  def axis_size(self, axis: str) -> int:
    return self.shape[AXES.index(axis)]

  def group(self, axis: str):
    return self.groups.get(axis)


def free_port() -> int:
  """A TCP port on localhost that nothing listens on now."""
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def rank_device(rank: int, device: str = 'cuda') -> torch.device:
  """The device of local rank `rank`: cuda:(rank mod the cards here) on the
  card (the card must be there), the CPU for device 'cpu'."""
  if torch.device(device).type == 'cpu':
    return torch.device('cpu')
  if not torch.cuda.is_available():
    raise RuntimeError('no CUDA card is available; pass --device cpu to run '
                       'the ranks on the CPU')
  return torch.device('cuda', rank % torch.cuda.device_count())


def _choose_backend(store, rank: int, world: int,
                    device: torch.device) -> str:
  """NCCL when every rank has a card of its own, else gloo; every rank
  writes its host and device into the store and reads the others'."""
  where = ('cpu' if device.type != 'cuda' else
           f'{os.environ.get("CUDA_VISIBLE_DEVICES", "")}/{device.index}')
  mine = f'{socket.gethostname()}:{where}'
  store.set(f'device/{rank}', mine)
  seen = [store.get(f'device/{r}').decode() for r in range(world)]
  if any(s.endswith(':cpu') for s in seen) or len(set(seen)) < world:
    return 'gloo'
  return 'nccl'


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = 'cuda') -> Tuple[str, torch.device]:
  """Starts this process's rank: the default process group over a TCP store
  at `coordinator` ('host:port'; rank 0 serves it) with `num_processes`
  ranks, this one `process_id`. Without them, torchrun's MASTER_ADDR,
  MASTER_PORT, WORLD_SIZE and RANK. The rank's device is
  `rank_device(LOCAL_RANK or rank, device)`, set as the current card.
  Returns (backend, device)."""
  if coordinator is None:
    env = os.environ
    if 'MASTER_ADDR' not in env or 'RANK' not in env:
      raise ValueError('initialize needs coordinator, num_processes and '
                       'process_id, or torchrun\'s MASTER_ADDR, MASTER_PORT, '
                       'WORLD_SIZE and RANK')
    coordinator = f'{env["MASTER_ADDR"]}:{env.get("MASTER_PORT", "29500")}'
    num_processes = int(env['WORLD_SIZE'])
    process_id = int(env['RANK'])
  if num_processes is None or process_id is None:
    raise ValueError('initialize: --coordinator needs --num_processes and '
                     '--process_id')
  host, port = coordinator.rsplit(':', 1)
  local = int(os.environ.get('LOCAL_RANK', process_id))
  dev = rank_device(local, device)
  if dev.type == 'cuda':
    torch.cuda.set_device(dev)
  store = dist.TCPStore(host, int(port), num_processes,
                        is_master=process_id == 0,
                        timeout=COLLECTIVE_TIMEOUT)
  backend = _choose_backend(store, process_id, num_processes, dev)
  dist.init_process_group(backend, store=store, rank=process_id,
                          world_size=num_processes,
                          timeout=COLLECTIVE_TIMEOUT)
  return backend, dev


def shutdown() -> None:
  """Ends this process's rank (when one was started)."""
  if dist.is_initialized():
    dist.destroy_process_group()


def _run_rank(rank: int, fn: Callable, world: int, port: int, args) -> None:
  fn(rank, world, f'127.0.0.1:{port}', *args)


def spawn(fn: Callable, world: int, args: Sequence = ()) -> None:
  """Runs fn(rank, world, coordinator, *args) in `world` new 'spawn'
  processes on this host (`fn` importable, `args` picklable), each to call
  `initialize(coordinator, world, rank, ...)`; returns when all have ended
  and raises if one failed."""
  import torch.multiprocessing as mp
  mp.start_processes(_run_rank, args=(fn, world, free_port(), tuple(args)),
                     nprocs=world, join=True, start_method='spawn')


def make_mesh(ensemble: int = 1, data: int = 1, model: int = 1) -> Mesh:
  """This rank's Mesh over (ensemble, data, model), whose product must be
  the number of ranks (1 without a process group), with a process group
  per axis of size > 1. Every rank must call it, in the same order."""
  world = dist.get_world_size() if dist.is_initialized() else 1
  rank = dist.get_rank() if dist.is_initialized() else 0
  shape = (ensemble, data, model)
  if ensemble * data * model != world:
    raise ValueError(f'mesh {ensemble}x{data}x{model}='
                     f'{ensemble * data * model} != {world} ranks')
  groups = {}
  if world > 1:
    grid = np.arange(world).reshape(shape)
    for i, axis in enumerate(AXES):
      if shape[i] == 1:
        continue
      lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
      # new_group is collective: every rank creates every group.
      for line in lines:
        group = dist.new_group([int(r) for r in line])
        if rank in line:
          groups[axis] = group
  return Mesh(shape=shape, rank=rank, groups=groups)


def data_rows(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
  """[lo, hi): the global batch rows of this rank's data coordinate."""
  dp = mesh.axis_size('data')
  if batch_size % dp:
    raise ValueError(f'batch_size ({batch_size}) must be divisible by the '
                     f'data axis ({dp})')
  i = mesh.coords['data']
  return i * batch_size // dp, (i + 1) * batch_size // dp


def local_batch_plan(mesh: Mesh, batch_size: int
                     ) -> Tuple[np.ndarray, List[Tuple[int, slice]]]:
  """(rows, blocks), as the reference's: rows, the ascending global batch
  rows this rank packs ([r·B/dp, (r+1)·B/dp) of its data coordinate r;
  ranks along the ensemble and model axes pack the same rows); blocks,
  (rank, slice of the local rows) for the one device of this process."""
  lo, hi = data_rows(mesh, batch_size)
  return np.arange(lo, hi), [(mesh.rank, slice(0, hi - lo))]


def assemble_local_batch(mesh: Mesh, batch_size: int, blocks,
                         batch: Dict[str, np.ndarray],
                         device: torch.device | str = 'cpu'
                         ) -> Dict[str, torch.Tensor]:
  """This rank's shard of the global batch from its locally packed rows
  (see local_batch_plan): its block of each array, on `device`. Nothing
  moves between ranks."""
  ((_, sl),) = blocks
  rows = data_rows(mesh, batch_size)
  out = {}
  for k, v in batch.items():
    v = np.asarray(v)[sl]
    if v.shape[0] != rows[1] - rows[0]:
      raise ValueError(f'{k}: {v.shape[0]} local rows, the plan has '
                       f'{rows[1] - rows[0]}')
    out[k] = torch.as_tensor(v).to(device)
  return out

