"""Derived forcing fields: year and day progress.

Counterpart of `gencast_tpu.data.forcings` for the four generated forcings
GenCast uses (`registry.GENERATED_FORCING_VARS`), as numpy builders keyed on
seconds-since-epoch timestamps. The top-of-atmosphere solar radiation
(GraphCast's forcing) is not carried over yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

SEC_PER_DAY = 86400
AVG_DAY_PER_YEAR = 365.24219
AVG_SEC_PER_YEAR = SEC_PER_DAY * AVG_DAY_PER_YEAR


def year_progress(seconds_since_epoch: np.ndarray) -> np.ndarray:
  """Year phase in [0, 1) per timestamp (tropical-year approximation)."""
  years = (np.asarray(seconds_since_epoch, np.float64) / SEC_PER_DAY
           / np.float64(AVG_DAY_PER_YEAR))
  return np.mod(years, 1.0).astype(np.float32)


def day_progress(seconds_since_epoch: np.ndarray,
                 lon_deg: np.ndarray) -> np.ndarray:
  """Local solar-day phase in [0, 1): [T, lon]."""
  greenwich = (np.mod(np.asarray(seconds_since_epoch, np.float64),
                      SEC_PER_DAY) / SEC_PER_DAY)
  offsets = np.deg2rad(np.asarray(lon_deg, np.float64)) / (2 * np.pi)
  return np.mod(greenwich[..., None] + offsets, 1.0).astype(np.float32)


def generated_forcings(seconds_since_epoch: np.ndarray,
                       lat_deg: np.ndarray,
                       lon_deg: np.ndarray) -> Dict[str, np.ndarray]:
  """The four GENERATED_FORCING_VARS as [T, lat, lon] fields."""
  t = np.asarray(seconds_since_epoch)
  nlat, nlon = len(lat_deg), len(lon_deg)
  yp = year_progress(t)  # [T]
  dp = day_progress(t, lon_deg)  # [T, lon]

  def tile_year(x):
    return np.broadcast_to(x[:, None, None], (len(t), nlat, nlon)).copy()

  def tile_day(x):
    return np.broadcast_to(x[:, None, :], (len(t), nlat, nlon)).copy()

  phase_y = yp * (2 * np.pi)
  phase_d = dp * (2 * np.pi)
  return {
      'year_progress_sin': tile_year(np.sin(phase_y)),
      'year_progress_cos': tile_year(np.cos(phase_y)),
      'day_progress_sin': tile_day(np.sin(phase_d)),
      'day_progress_cos': tile_day(np.cos(phase_d)),
  }


def all_forcings(seconds_since_epoch: np.ndarray,
                 lat_deg: np.ndarray, lon_deg: np.ndarray,
                 variables: Sequence[str]) -> Dict[str, np.ndarray]:
  """Builds the requested generated forcing variables, each [T, lat, lon]."""
  out = {}
  generated = None
  for name in variables:
    if name == 'toa_incident_solar_radiation':
      raise NotImplementedError(
          'toa_incident_solar_radiation (ops/solar.py) is not ported: it '
          'comes with GraphCast (ROADMAP.md, "Still to port": GraphCast)')
    if generated is None:
      generated = generated_forcings(seconds_since_epoch, lat_deg, lon_deg)
    if name not in generated:
      raise ValueError(f'unknown forcing variable {name}')
    out[name] = generated[name]
  return out
