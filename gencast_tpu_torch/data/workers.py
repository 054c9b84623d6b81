"""Out-of-process batch packing (the reference's scalable-Grain role).

Counterpart of `gencast_tpu.data.workers`, with the same contract: the
batch stream is bitwise the in-process `sources.batch_iterator`'s.

The reference's training input is a Grain ``MapDataset`` whose map workers
can run out-of-process (reference: training/era5_dataset.py:797-842). The
repo's single background thread (`data.prefetch.DevicePrefetcher`) covers
the transfer-overlap half of that role; this module covers the other half:
CPU-parallel window packing for hosts where one core cannot keep the
device fed (0.25-degree batches cost seconds of single-core file-read and
pack work).

Design
------
`ParallelBatchIterator` reproduces `sources.batch_iterator`'s index stream
EXACTLY (same seed -> same permutations -> same window selection, including
the multi-host `rows` slicing), but ships each batch's window indices to a
`ProcessPoolExecutor` worker that owns its own source instance (h5py
handles cannot cross processes; each worker opens its own files). Batches
come back through the pipe in submission order, so the output is bitwise
identical to the in-process iterator — tests/test_torch_era5_pipeline.py
pins that oracle.

Workers are started with the 'spawn' context: the parent holds a CUDA
context (and the prefetch thread), which make fork() unsafe.
Workers never touch a device: they import the port's numpy code paths
(and torch, which initializes no CUDA on import) and h5py for NetCDF.

Composition with the device pipeline: wrap this iterator in
`DevicePrefetcher(it, transform=put)` — workers pack on their own cores,
the prefetch thread overlaps the host->device transfer, and the train
loop consumes batches on the device.
"""

from __future__ import annotations

import collections
from concurrent.futures import ProcessPoolExecutor
import multiprocessing
from typing import Callable, Dict, Iterator, Sequence

import numpy as np

from gencast_tpu_torch.data import sources as sources_lib

# Per-worker source instance, built once by the pool initializer.
_SOURCE = None


def _init_worker(source_factory) -> None:
  global _SOURCE
  _SOURCE = source_factory()


def _source_len() -> int:
  return len(_SOURCE)


def _pack_batch(indices: Sequence[int],
                num_target_frames: int) -> Dict[str, np.ndarray]:
  ws = [_SOURCE.sample(int(i), num_target_frames) for i in indices]
  return {
      'inputs': np.stack([w.inputs for w in ws]),
      'targets': np.stack([w.targets for w in ws]),
      'forcings': np.stack([w.forcings for w in ws]),
  }


class ParallelBatchIterator:
  """Multi-process drop-in for `sources.batch_iterator`.

  Args:
    source_factory: picklable zero-arg callable returning a
      `WindowedSource` (e.g. ``functools.partial(Era5NpzSource, dir,
      task)``). Called once per worker process AND once via a worker to
      learn ``len(source)`` — the parent never builds a source itself.
    batch_size / shuffle / seed / loop / rows: exactly as in
      `sources.batch_iterator`; the index stream is replicated so output
      batches are bitwise identical to the in-process iterator.
    num_target_frames: forwarded to ``source.sample``: windows of K
      target frames (GraphCast's AR training), of which the source holds
      K - 1 fewer than of one frame.
    num_workers: worker process count ('spawn' processes); at most
      ``num_workers + 2`` batches are submitted and not yet consumed.

  The training CLI packs AR windows in-process (`--data_workers` is
  ignored under `--ar_steps` > 1, as in the reference); this class packs
  them for callers of the library.

  Iterate, or use as a context manager; `close()` shuts the pool down
  promptly (pending batches are cancelled where possible). Worker
  exceptions surface on the consumer at the corresponding step.
  """

  def __init__(self, source_factory: Callable[[], 'sources_lib.WindowedSource'],
               batch_size: int, *, num_workers: int,
               shuffle: bool = True, seed: int = 0, loop: bool = True,
               rows=None, num_target_frames: int = 1):
    if num_workers < 1:
      raise ValueError(f'num_workers must be >= 1, got {num_workers}')
    if num_target_frames < 1:
      raise ValueError(
          f'num_target_frames must be >= 1, got {num_target_frames}')
    self._num_target_frames = num_target_frames
    self._closed = False
    self._pool = ProcessPoolExecutor(
        max_workers=num_workers,
        mp_context=multiprocessing.get_context('spawn'),
        initializer=_init_worker, initargs=(source_factory,))
    try:
      # len(source) counts windows of one target frame; a K-frame window
      # needs K - 1 more trailing frames, so the last K - 1 starts go.
      n = self._pool.submit(_source_len).result() - (num_target_frames - 1)
      # The selection stream is SHARED with sources.batch_iterator, so the
      # output batches are bitwise the in-process iterator's by
      # construction (tests/test_torch_era5_pipeline.py pins that oracle).
      self._sel_iter = sources_lib.selection_stream(
          n, batch_size, shuffle=shuffle, seed=seed, loop=loop, rows=rows)
      self._pending: collections.deque = collections.deque()
      self._depth = num_workers + 2
      self._fill()
    except BaseException:
      self._pool.shutdown(wait=False, cancel_futures=True)
      raise

  def _fill(self) -> None:
    while len(self._pending) < self._depth:
      sel = next(self._sel_iter, None)
      if sel is None:
        return
      self._pending.append(
          self._pool.submit(_pack_batch, [int(i) for i in sel],
                            self._num_target_frames))

  def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
    return self

  def __next__(self) -> Dict[str, np.ndarray]:
    if self._closed or not self._pending:
      raise StopIteration
    fut = self._pending.popleft()
    try:
      batch = fut.result()
    except BaseException:
      self.close()
      raise
    self._fill()
    return batch

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  def close(self) -> None:
    if self._closed:
      return
    self._closed = True
    self._pending.clear()
    self._pool.shutdown(wait=False, cancel_futures=True)
