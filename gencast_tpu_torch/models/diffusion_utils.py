"""EDM noise-level schedules (Karras et al. 2022).

Reference: gencast/samplers_utils.py:350-452.
"""

from __future__ import annotations

import numpy as np


def rho_inverse_cdf(min_value: float, max_value: float, rho: float, cdf):
  """Quantiles of the rho distribution (Beta[rho,1] rescaled to
  [min_value, max_value]); works on numpy arrays and scalars."""
  return (min_value ** (1 / rho)
          + cdf * (max_value ** (1 / rho) - min_value ** (1 / rho))) ** rho


def noise_schedule(max_noise_level: float, min_noise_level: float,
                   num_noise_levels: int, rho: float) -> np.ndarray:
  """Descending sigma schedule with a trailing zero."""
  levels = rho_inverse_cdf(min_noise_level, max_noise_level, rho,
                           np.linspace(1.0, 0.0, num_noise_levels))
  return np.append(levels, 0.0)


def stochastic_churn_rate_schedule(
    noise_levels: np.ndarray,
    stochastic_churn_rate: float,
    churn_min_noise_level: float,
    churn_max_noise_level: float) -> np.ndarray:
  """Per-level churn rate gamma_i, clamped to sqrt(2)-1 as in the paper."""
  num = len(noise_levels) - 1  # exclude trailing zero
  per_step = min(stochastic_churn_rate / num, np.sqrt(2.0) - 1.0)
  active = ((churn_min_noise_level <= noise_levels[:-1])
            & (noise_levels[:-1] <= churn_max_noise_level))
  return active * per_step
