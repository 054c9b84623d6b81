"""Builds shared libraries from sources in the checkout, at first use.

Outputs go to `build/gencast_tpu_torch/` at the repository root (listed in
.gitignore), keyed by a hash of the sources and the compiler commands, so a
changed source or flag rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import Sequence, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, 'build', 'gencast_tpu_torch')


def compile_shared(compile_cmd: Sequence[str], link_cmd: Sequence[str],
                   sources: Sequence[str], stem: str,
                   headers: Sequence[str] = ()) -> Tuple[str, str]:
  """Builds `sources` into one shared library unless it already exists.

  Every source is compiled to an object at the same time, one compiler
  process each (`compile_cmd + ['-c', src, '-o', obj]`); the objects are
  then linked by `link_cmd + ['-o', out] + objects`. `headers` are hashed
  with the sources (so editing one rebuilds) but not passed to the compiler.

  Returns (path of the shared library, the compilers' stderr; empty when
  the library was already built). Raises subprocess.CalledProcessError
  (with the compiler's output attached, and written to stderr) when a
  compiler fails.
  """
  h = hashlib.sha256(' '.join([*compile_cmd, '|', *link_cmd]).encode())
  for src in list(sources) + list(headers):
    with open(src, 'rb') as f:
      h.update(f.read())
  out = os.path.join(BUILD_DIR, f'{stem}_{h.hexdigest()[:16]}.so')
  if os.path.exists(out):
    return out, ''
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = f'{out}.tmp{os.getpid()}'
  objects = [f'{tmp}.{i}.o' for i in range(len(sources))]
  procs = [subprocess.Popen([*compile_cmd, '-c', src, '-o', obj],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
           for src, obj in zip(sources, objects)]
  logs = []
  failed = None
  for proc in procs:
    stdout, stderr = proc.communicate()
    logs.append(stderr)
    if proc.returncode and failed is None:
      failed = subprocess.CalledProcessError(proc.returncode, proc.args,
                                             stdout, stderr)
  try:
    if failed is not None:
      sys.stderr.write(failed.stderr or '')
      raise failed
    done = subprocess.run([*link_cmd, '-o', tmp, *objects], check=True,
                          capture_output=True, text=True)
    logs.append(done.stderr)
  finally:
    for obj in objects:
      if os.path.exists(obj):
        os.remove(obj)
  os.replace(tmp, out)
  return out, ''.join(logs)
