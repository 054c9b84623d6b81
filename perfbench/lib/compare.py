"""The numbers that decide `correct`, each beside its limit.

A forecast is judged in the sampler's space (normalized residuals): the
relative L2 gap ||program - reference|| / ||reference|| over every value
the reference gives (sea-surface temperature is missing over land on both
sides, and a value missing on one side only makes the gap infinite).
A training step is judged by the gap of norms, leaf by leaf, against the
reference's norm of that leaf or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class Comparison:
  name: str
  value: float
  limit: float

  @property
  def ok(self) -> bool:
    return math.isfinite(self.value) and self.value <= self.limit


def relative_l2(got: torch.Tensor, want: torch.Tensor) -> float:
  got, want = got.double(), want.double()
  seen = torch.isfinite(want)
  if not torch.equal(seen, torch.isfinite(got)):
    return math.inf
  return float(torch.linalg.vector_norm((got - want)[seen])
               / torch.linalg.vector_norm(want[seen]))


def norm_gaps(got: Dict[str, float], want: Dict[str, float]
              ) -> Dict[str, float]:
  """Per leaf |got - want| / max(want, median of want's leaves)."""
  median = float(torch.tensor(list(want.values())).median())
  return {n: abs(got[n] - w) / max(w, median, 1e-30)
          for n, w in want.items()}


def worst(gaps: Dict[str, float]) -> float:
  return max(gaps.values()) if gaps else math.inf


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
  return {n: float(torch.linalg.vector_norm(t.double()))
          for n, t in tensors.items()}


def loss_gap(got: List[float], want: List[float]) -> float:
  """The largest relative gap of a step's loss."""
  return max(abs(g - w) / abs(w) for g, w in zip(got, want))
