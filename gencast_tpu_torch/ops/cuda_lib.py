"""Builds and loads the port's CUDA kernels (csrc/*.cu) through ctypes.

All kernels are compiled at first use into a shared library with a plain C
interface (no PyTorch headers, no ninja): one nvcc process per source, all
started together, then one link. The library is keyed by source hash in the
build directory and loaded with ctypes. Every C entry point returns a
cudaError_t, which `check` turns into an exception.

Nothing here runs at import: the CPU tests import every module, and the CPU
machine has neither nvcc nor a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from gencast_tpu_torch import _build, utils

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # dtype, head_dim, q, k, v, mask_tiles, kv_ids, pair_ids, o, lse,
    # batch, n, h, num_q_tiles, num_active, pad_tile, scale, stream
    'gt_sparse_attention_fwd': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _F, _P],
    'gt_sparse_attention_tile': [],
    # dtype, head_dim, q, k, v, dout, lse, delta, mask_tiles, kv_ids,
    # pair_ids, dq, batch, n, h, num_q_tiles, num_active, pad_tile, scale,
    # stream
    'gt_sparse_attention_bwd_dq': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # ... q_ids, pair_ids, dk, dv, batch, n, h, num_kv_tiles, num_active,
    # pad_tile, scale, stream
    'gt_sparse_attention_bwd_dkv': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                    _P],
    # ... q_ids, pair_ids, dk, dv, partial, batch, n, h, num_kv_tiles,
    # num_active, pad_tile, scale, stream
    'gt_sparse_attention_bwd_dkvq': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _P],
    # kind, dtype, head_dim, num_active
    'gt_sparse_attention_bwd_smem': [_I, _I, _I, _I],
    # dtype, head_dim, partial, slot_ids, valid, dq, batch, n, h,
    # num_q_tiles, num_slots, num_active, scale, stream
    'gt_sparse_attention_dq_reduce': [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _F, _P],
    # dtype, head_dim, q, k, v, mask, o, lse, batch, n, h, num_blocks,
    # block_size, scale, stream
    'gt_banded_attention_fwd': [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _F, _P],
    # dtype, head_dim, q, k, v, dout, lse, delta, mask, dq, batch, n, h,
    # num_blocks, block_size, scale, stream
    'gt_banded_attention_bwd_dq': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _F, _P],
    # ... mask, dk, dv, batch, n, h, num_blocks, block_size, scale, stream
    'gt_banded_attention_bwd_dkv': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _I, _I, _I, _F, _P],
    # dtype, data, row_ptr, perm, out, num_segments, f, split_degree,
    # num_sms, stream
    'gt_segment_sum': [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, x, dy, scale, dx, parts, dscale, doffset, batch, rows, c,
    # row_stride, batch_stride, blocks_per_batch, eps, stream
    'gt_ln_film_bwd': [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L,
                       _I, _F, _P],
    # dtype, c
    'gt_ln_film_bwd_blocks_per_sm': [_I, _I],
    # dtype, x, scale, offset, y, batch, rows, c, row_stride, batch_stride,
    # blocks_per_batch, eps, stream
    'gt_ln_film_fwd': [_I, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _F, _P],
    # dtype, c
    'gt_ln_film_fwd_blocks_per_sm': [_I, _I],
    # mark (its index in utils.MARKS), stream
    'gt_span_mark': [_I, _P],
}


class KernelCounter:
  """Launch count of one kernel: its wrapper adds one where it launches,
  and a `Graph` adds the launches it captured at each replay."""

  def __init__(self, name: str, source: str, replaces: str):
    self.name = name
    self.source = source      # path in the repository
    self.replaces = replaces  # file:line of the TPU kernel it ports
    self.launches = 0
    COUNTERS.append(self)

  def reset(self) -> None:
    self.launches = 0


# Every kernel's counter, in the order the kernels' modules made them.
COUNTERS: List[KernelCounter] = []


class CapturedLaunches:
  """The launches of each kernel that a capture recorded.

  A wrapper counts in Python where it launches, so under capture it counts
  launches that have not run, and a replay runs them without Python.
  `recording()` takes the counts a block adds and sets the counters back;
  `replayed()` adds them once per replay.
  """

  def __init__(self):
    self.launches: Dict[KernelCounter, int] = {}

  @contextlib.contextmanager
  def recording(self):
    before = [c.launches for c in COUNTERS]
    try:
      yield self
    finally:
      self.launches = {c: c.launches - n for c, n in zip(COUNTERS, before)
                       if c.launches != n}
      for c, n in zip(COUNTERS, before):
        c.launches = n

  def replayed(self) -> None:
    for c, n in self.launches.items():
      c.launches += n


class Graph:
  """One CUDA graph of a step of the port, warmed up and captured on a side
  stream of its own and replayed on the current stream, with its kernels'
  launches counted per replay.

  The first call of `fn` runs eagerly on the side stream (`warm_up`): it
  builds the kernel library, fills the launch caches and lets lazily made
  state (an optimizer's moments, cuBLAS's workspace) exist before the
  capture, which would otherwise freeze its creation into every replay.
  A capture or replay that fails raises; nothing falls back to eager.
  """

  def __init__(self, device: torch.device):
    self.device = device
    self.stream = torch.cuda.Stream(device)
    self.graph: Optional[torch.cuda.CUDAGraph] = None
    self.counts = CapturedLaunches()
    self.capture_seconds = 0.0
    self.pool_bytes = 0  # device memory the capture reserved: its pool

  def warm_up(self, fn: Callable):
    """fn() run eagerly on the side stream, after the current stream's
    work; its result, ready for the current stream. (Blocks the side
    stream frees are reused only by later side-stream work, which again
    waits for the current stream first.)"""
    current = torch.cuda.current_stream(self.device)
    self.stream.wait_stream(current)
    with torch.cuda.stream(self.stream):
      out = fn()
    current.wait_stream(self.stream)
    return out

  def capture(self, fn: Callable):
    """Captures fn() (after a warm-up) into this graph; returns its static
    outputs, which each replay overwrites."""
    if self.graph is not None:
      raise RuntimeError('this graph is captured already')
    with utils.span('graph.capture'):
      t0 = time.perf_counter()
      self.stream.wait_stream(torch.cuda.current_stream(self.device))
      torch.cuda.empty_cache()
      reserved = torch.cuda.memory_reserved(self.device)
      graph = torch.cuda.CUDAGraph()
      with self.counts.recording():
        # Thread-local: the packing thread (--prefetch) goes on copying
        # batches to the card and computing TISR on streams of its own
        # while the step thread captures.
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode='thread_local'):
          out = fn()
      torch.cuda.current_stream(self.device).wait_stream(self.stream)
      self.graph = graph
      self.capture_seconds = time.perf_counter() - t0
      self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
    return out

  def replay(self) -> None:
    self.graph.replay()
    self.counts.replayed()


class GraphedCall:
  """One call captured in a `Graph` over static input buffers. The caller
  loads the buffers (`load`); the first call of `fn(*buffers)` runs eagerly
  on the graph's side stream (its warm-up) and is then captured; every
  later call replays. A replay's output is the graph's own buffer, which
  the next replay overwrites."""

  def __init__(self, buffers: Sequence[torch.Tensor]):
    self.graph = Graph(buffers[0].device)
    self.buffers = tuple(buffers)
    self.out = None

  def load(self, *values, first: int = 0) -> None:
    """Copies `values` into the buffers from `first` on (a number fills)."""
    for buf, value in zip(self.buffers[first:], values):
      if isinstance(value, torch.Tensor):
        buf.copy_(value)
      else:
        buf.fill_(value)

  def __call__(self, fn: Callable):
    # `fn` is passed per call, not kept: a graph lives on its model
    # (`GraphedCalls`) and must not keep it alive.
    def call():
      return fn(*self.buffers)

    if self.out is None:
      out = self.graph.warm_up(call)
      self.out = self.graph.capture(call)
      return out
    self.graph.replay()
    return self.out


def signature(*tensors: torch.Tensor) -> tuple:
  """The shapes, dtypes and devices of `tensors`: a `GraphedCalls` key."""
  return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


class GraphedCalls:
  """A model's graphed calls, one per key (the shapes, dtypes and devices
  of a call's inputs).

  They hold the addresses of the model's parameters, so they live on the
  model and die with it: `Bfloat16Cast.refresh()` copies new weights into
  the serving copy's parameters in place, where its graphs read them, and
  a serving copy that it makes anew (the model moved or sharded) takes the
  old graphs along with the old copy. A deep copy of the model (how that
  copy is made) starts with none, since a CUDA graph cannot be copied; a
  model moved by `.to()` must start with none too (its `_apply`).
  """

  def __init__(self):
    self.graphs: Dict[tuple, GraphedCall] = {}

  def __deepcopy__(self, memo):
    return GraphedCalls()

  def get(self, key: tuple,
          buffers: Callable[[], Sequence[torch.Tensor]]) -> GraphedCall:
    """The call of `key`, made over `buffers()` the first time."""
    if key not in self.graphs:
      self.graphs[key] = GraphedCall(buffers())
    return self.graphs[key]


class _Library:
  """The lazily built shared library and its compiler log."""

  def __init__(self):
    self._lock = threading.Lock()
    self.lib: Optional[ctypes.CDLL] = None
    self.compiler_log = ''

  def get(self) -> ctypes.CDLL:
    with self._lock:
      if self.lib is None:
        self.lib = self._load()
      return self.lib

  def _load(self) -> ctypes.CDLL:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which('nvcc') or (
        os.path.join(CUDA_HOME, 'bin', 'nvcc') if CUDA_HOME else None)
    if nvcc is None or not os.path.exists(nvcc):
      raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh')))
    path, log = _build.compile_shared(
        [nvcc, *NVCC_FLAGS, f'-I{CSRC_DIR}'],
        [nvcc, '-shared', '-Xcompiler', '-fPIC'], sources,
        'gencast_tpu_torch_kernels', headers=headers)
    self.compiler_log = log
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
      fn = getattr(lib, name)
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
    return lib


LIBRARY = _Library()


def library() -> ctypes.CDLL:
  return LIBRARY.get()


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
  """Streaming multiprocessors of a card: the persistent grids (kernels B
  and E, the LN+FiLM forward) take a multiple of it."""
  return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_aligned(addresses: Mapping[str, int]) -> None:
  """Raises unless every address (by operand name; `tensor.data_ptr()`) is a
  multiple of 16 bytes: the kernels copy with 16-byte cp.async, read
  fragments with ldmatrix and load rows in 16-byte vectors, which fault or
  read wrong on other addresses. A view that starts inside an allocation can
  break this."""
  for name, address in addresses.items():
    if address % 16:
      raise ValueError(f'{name} starts at address {address:#x}, not a '
                       'multiple of 16 bytes')


def span_mark(index: int, device: torch.device) -> None:
  """Launches the span mark `index` (`utils.MARKS`; csrc/span_mark.cu) on
  `device`'s current stream: under capture, into the graph."""
  code = library().gt_span_mark(
      index, torch.cuda.current_stream(device).cuda_stream)
  check(code, 'gt_span_mark')


def check(code: int, what: str) -> None:
  """Raises if a C entry point returned a nonzero cudaError_t."""
  if code != 0:
    raise RuntimeError(f'{what}: CUDA error {code} at launch')
