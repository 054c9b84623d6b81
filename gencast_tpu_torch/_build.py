"""Builds shared libraries from sources in the checkout, at first use.

Outputs go to `build/gencast_tpu_torch/` at the repository root (listed in
.gitignore), keyed by a hash of the sources and the compiler command, so a
changed source or flag rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Sequence, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, 'build', 'gencast_tpu_torch')


def compile_shared(command: Sequence[str], sources: Sequence[str],
                   stem: str, headers: Sequence[str] = ()) -> Tuple[str, str]:
  """Runs `command + ['-o', out] + sources` unless `out` already exists.

  `headers` are hashed with the sources (so editing one rebuilds) but not
  passed to the compiler.

  Returns (path of the shared library, the compiler's stderr; empty when
  the library was already built). Raises subprocess.CalledProcessError
  (with the compiler's output attached) when the compiler fails.
  """
  h = hashlib.sha256(' '.join(command).encode())
  for src in list(sources) + list(headers):
    with open(src, 'rb') as f:
      h.update(f.read())
  out = os.path.join(BUILD_DIR, f'{stem}_{h.hexdigest()[:16]}.so')
  if os.path.exists(out):
    return out, ''
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = f'{out}.tmp{os.getpid()}'
  done = subprocess.run(list(command) + ['-o', tmp] + list(sources),
                        check=True, capture_output=True, text=True)
  os.replace(tmp, out)
  return out, done.stderr
