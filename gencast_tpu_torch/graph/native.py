"""ctypes loader for the native containing-triangle query (host code).

Compiles the port's own copy of the reference package's C++ source
(`_native/containing_triangle.cpp` beside this module) with g++ on first
use into the port's build directory. Every caller has a numpy fallback, so
the native path is a speed-up of the host-side graph build, not a
requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from gencast_tpu_torch import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_native',
                      'containing_triangle.cpp')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
  if not os.path.exists(SOURCE):
    return None
  path = None
  for flags in (['-O3', '-march=native', '-fPIC', '-fopenmp'],
                # Retry without OpenMP (not all toolchains ship libgomp).
                ['-O3', '-fPIC']):
    try:
      path, _ = _build.compile_shared(
          ['g++', *flags], ['g++', '-shared', *flags], [SOURCE],
          'containing_triangle')
      break
    except (subprocess.CalledProcessError, FileNotFoundError):
      continue
  if path is None:
    return None
  lib = ctypes.CDLL(path)
  lib.gt_containing_triangle.restype = ctypes.c_int
  lib.gt_containing_triangle.argtypes = [
      ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
      ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
      ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
      ctypes.c_double,
      ctypes.POINTER(ctypes.c_int64),
  ]
  return lib


def get_lib() -> Optional[ctypes.CDLL]:
  """The native library, building it on first call; None if unavailable."""
  global _lib, _build_failed
  if _lib is not None or _build_failed:
    return _lib
  with _lock:
    if _lib is None and not _build_failed:
      _lib = _load()
      _build_failed = _lib is None
  return _lib


def containing_triangle(points: np.ndarray, vertices: np.ndarray,
                        faces: np.ndarray) -> Optional[np.ndarray]:
  """Native containing-triangle query; None if the library is unavailable."""
  lib = get_lib()
  if lib is None:
    return None
  pts = np.ascontiguousarray(points, dtype=np.float64)
  verts = np.ascontiguousarray(vertices, dtype=np.float64)
  fcs = np.ascontiguousarray(faces, dtype=np.int32)
  out = np.empty(pts.shape[0], dtype=np.int64)
  # Cell size ~ the largest face extent so ring-1 lookups almost always hit.
  v = verts[fcs]
  extent = float(np.max(v.max(axis=1) - v.min(axis=1)))
  cell = max(extent * 1.1, 1e-3)
  rc = lib.gt_containing_triangle(
      pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), pts.shape[0],
      verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), verts.shape[0],
      fcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), fcs.shape[0],
      cell, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
  if rc != 0 or (out < 0).any():
    return None
  return out
