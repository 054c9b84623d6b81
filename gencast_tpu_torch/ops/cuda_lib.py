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

import ctypes
import glob
import os
import shutil
import threading
import time
from typing import Mapping, Optional

from gencast_tpu_torch import _build

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
    # data, row_ptr, perm, out, num_segments, f, stream
    'gt_segment_sum': [_P, _P, _P, _P, _I, _I, _P],
    # dtype, x, dy, scale, dx, dscale_part, doffset_part, dscale, doffset,
    # batch, rows, c, row_stride, batch_stride, rows_per_warp, num_blocks,
    # eps, stream
    'gt_ln_film_bwd': [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                       _L, _I, _I, _F, _P],
}


class KernelCounter:
  """Launch count of one kernel: its wrapper adds one where it launches."""

  def __init__(self, name: str, source: str, replaces: str):
    self.name = name
    self.source = source      # path in the repository
    self.replaces = replaces  # file:line of the TPU kernel it ports
    self.launches = 0

  def reset(self) -> None:
    self.launches = 0


class _Library:
  """The lazily built shared library, its build time and compiler log."""

  def __init__(self):
    self._lock = threading.Lock()
    self.lib: Optional[ctypes.CDLL] = None
    self.build_seconds = 0.0
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
    t0 = time.perf_counter()
    path, log = _build.compile_shared(
        [nvcc, *NVCC_FLAGS, f'-I{CSRC_DIR}'],
        [nvcc, '-shared', '-Xcompiler', '-fPIC'], sources,
        'gencast_tpu_torch_kernels', headers=headers)
    self.build_seconds = time.perf_counter() - t0
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


def check_aligned(addresses: Mapping[str, int]) -> None:
  """Raises unless every address (by operand name; `tensor.data_ptr()`) is a
  multiple of 16 bytes: the kernels copy with 16-byte cp.async and read
  fragments with ldmatrix, which fault or read wrong on other addresses. A
  view that starts inside an allocation can break this."""
  for name, address in addresses.items():
    if address % 16:
      raise ValueError(f'{name} starts at address {address:#x}, not a '
                       'multiple of 16 bytes')


def check(code: int, what: str) -> None:
  """Raises if a C entry point returned a nonzero cudaError_t."""
  if code != 0:
    raise RuntimeError(f'{what}: CUDA error {code} at launch')
