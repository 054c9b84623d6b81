"""Asynchronous host-to-device input pipeline (the reference's Grain role).

Counterpart of `gencast_tpu.data.prefetch`. A background thread pulls
batches from a host iterator (file reads and window packing), applies the
host-to-device transfer, and keeps up to `buffer_size` batches in flight,
so the training step consumes batches already on the device and does not
wait on host packing.

On the card the transfer is `CardCopy`: each batch is copied into pinned
host memory and sent with `non_blocking=True` on a side stream, and an
event marks the end of its copy. `arrived` makes the consuming stream wait
on that event and records the batch's tensors on that stream, so the
caching allocator cannot hand a batch's memory to the next copy while a
step still reads it. On the CPU the batch becomes tensors in place: no
pinning, nothing to wait on.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


class DevicePrefetcher:
  """Wraps a host batch iterator with background packing + device copy.

  Args:
    iterator: yields host batches (e.g. sources.batch_iterator dicts).
    transform: applied to each batch on the background thread, typically
      the host->device copy (`CardCopy`). Identity if None.
    buffer_size: max batches in flight (2 = classic double buffering).

  Iteration order is preserved; exceptions raised by the source or the
  transform surface on the consumer thread at the corresponding step.
  Use as an iterator or a context manager; `close()` stops the thread
  promptly even mid-buffer.
  """

  _DONE = object()

  def __init__(self, iterator: Iterator[Any],
               transform: Optional[Callable[[Any], Any]] = None,
               buffer_size: int = 2):
    if buffer_size < 1:
      raise ValueError(f'buffer_size must be >= 1, got {buffer_size}')
    self._it = iterator
    self._transform = transform or (lambda x: x)
    self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
    self._stop = threading.Event()
    self._done = False
    self._thread = threading.Thread(target=self._worker, daemon=True,
                                    name='gencast-prefetch')
    self._thread.start()

  def _put(self, item) -> bool:
    """Stop-aware blocking put. Returns False if close() raced us."""
    while not self._stop.is_set():
      try:
        self._q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _worker(self):
    try:
      for batch in self._it:
        if not self._put((self._transform(batch), None)):
          return
      self._put((self._DONE, None))
    except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
      # Must not drop the error even if the consumer is mid-step for
      # minutes: keep trying until it lands or close() is called, else the
      # consumer would block forever on an empty queue with a dead worker.
      self._put((None, e))

  def __iter__(self):
    return self

  def __next__(self):
    if self._stop.is_set() or self._done:
      raise StopIteration
    item, err = self._q.get()
    if err is not None:
      self.close()
      raise err
    if item is self._DONE:
      self._done = True
      raise StopIteration
    return item

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  def close(self):
    self._stop.set()
    # Drain so a blocked producer put() can observe the stop event.
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass
    self._thread.join(timeout=5.0)


@dataclasses.dataclass
class InFlight:
  """A batch whose copy to the card was enqueued on a side stream:
  its device tensors, the event recorded after the copy, and the pinned
  host tensors the copy reads (kept until the consumer waits)."""
  tensors: Dict[str, torch.Tensor]
  copied: torch.cuda.Event
  host: Dict[str, torch.Tensor]


class CardCopy:
  """Copies numpy batches (dicts of arrays) to `device` as tensors.

  On a CUDA device: into pinned host memory, then `non_blocking` on this
  object's side stream; returns an `InFlight` for `arrived`. On the CPU:
  the tensors themselves (sharing the arrays' memory)."""

  def __init__(self, device: torch.device):
    self.device = torch.device(device)
    self.stream = (torch.cuda.Stream(self.device)
                   if self.device.type == 'cuda' else None)

  def __call__(self, batch: Dict[str, np.ndarray]):
    if self.stream is None:
      return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
    host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in batch.items()}
    with torch.cuda.stream(self.stream):
      tensors = {k: v.to(self.device, non_blocking=True)
                 for k, v in host.items()}
      copied = torch.cuda.Event()
      copied.record(self.stream)
    return InFlight(tensors=tensors, copied=copied, host=host)


def arrived(item) -> Dict[str, torch.Tensor]:
  """The batch's device tensors, safe to use on the current stream: waits
  (on the device) for an `InFlight` copy and records its tensors on the
  current stream; anything else is returned as it is."""
  if not isinstance(item, InFlight):
    return item
  device = next(iter(item.tensors.values())).device
  stream = torch.cuda.current_stream(device)
  stream.wait_event(item.copied)
  for t in item.tensors.values():
    t.record_stream(stream)
  return item.tensors
