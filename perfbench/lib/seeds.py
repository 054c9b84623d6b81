"""Seeds of a run: every stream the benchmark draws is derived from the
run's --seed and a purpose, so the same seed gives the same inputs and
weights, and streams of different purposes do not overlap."""

from __future__ import annotations

import numpy as np

WEIGHTS, DATA, MEMBERS, POOL, STEPS, CHECK, STATS = range(1, 8)


def derive(seed: int, *keys: int) -> int:
  """A 63-bit seed from (seed, *keys)."""
  if seed < 0:
    raise ValueError(f'seeds are whole numbers of 0 or more, got {seed}')
  words = np.random.SeedSequence([seed, *keys]).generate_state(2, np.uint32)
  return (int(words[0]) << 32 | int(words[1])) & ((1 << 63) - 1)


def rng(seed: int, *keys: int) -> np.random.Generator:
  """A host generator of (seed, *keys), for choices the benchmark makes."""
  return np.random.default_rng(derive(seed, *keys))
