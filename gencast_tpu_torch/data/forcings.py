"""Derived forcing fields: year and day progress, and TISR.

Counterpart of `gencast_tpu.data.forcings`: the four generated forcings
GenCast uses (`registry.GENERATED_FORCING_VARS`), as numpy builders keyed on
seconds-since-epoch timestamps, and GraphCast's top-of-atmosphere incident
solar radiation (`ops.solar`), computed on the device the caller names and
returned as numpy.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch

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
                 variables: Sequence[str],
                 tisr_integration_period_s: int = 3600,
                 device: torch.device | str = 'cpu'
                 ) -> Dict[str, np.ndarray]:
  """Builds the requested forcing variables, each [T, lat, lon] numpy:
  GENERATED_FORCING_VARS, and toa_incident_solar_radiation computed on
  `device` (a 1-degree frame is 23.5 M flux evaluations)."""
  out = {}
  generated = None
  for name in variables:
    if name == 'toa_incident_solar_radiation':
      out[name] = _tisr_numpy(seconds_since_epoch, lat_deg, lon_deg,
                              tisr_integration_period_s, torch.device(device))
      continue
    if generated is None:
      generated = generated_forcings(seconds_since_epoch, lat_deg, lon_deg)
    if name not in generated:
      raise ValueError(f'unknown forcing variable {name}')
    out[name] = generated[name]
  return out


@functools.lru_cache(maxsize=None)
def _tisr_stream(device: torch.device) -> torch.cuda.Stream:
  return torch.cuda.Stream(device)


def _tisr_numpy(seconds_since_epoch, lat_deg, lon_deg, period_s: int,
                device: torch.device) -> np.ndarray:
  """TISR computed on `device`, as numpy. On the card it runs on a stream
  of its own (one per device, so the allocator's cached blocks are reused):
  a packing thread (--prefetch) neither queues behind the training step on
  the default stream nor waits for it when it copies the field back, which
  synchronizes this stream only."""
  from gencast_tpu_torch.ops import solar

  def tisr():
    return solar.tisr_for_grid(seconds_since_epoch, lat_deg, lon_deg,
                               integration_period_s=period_s,
                               device=device).cpu().numpy()

  if device.type != 'cuda':
    return tisr()
  if device.index is None:
    device = torch.device('cuda', torch.cuda.current_device())
  with torch.cuda.stream(_tisr_stream(device)):
    return tisr()
