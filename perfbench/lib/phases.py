"""The phases of a run's set-up, timed by the host's clock, for its log."""

from __future__ import annotations

import time
from typing import List, Tuple


class Phases:

  def __init__(self):
    self.parts: List[Tuple[str, float]] = []
    self._last = time.perf_counter()

  def mark(self, name: str) -> None:
    """Ends the phase `name`, which began at the last mark."""
    now = time.perf_counter()
    self.parts.append((name, now - self._last))
    self._last = now

  def __str__(self) -> str:
    return ', '.join(f'{n} {s:.3f}' for n, s in self.parts)
