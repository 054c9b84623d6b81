"""Top-of-atmosphere incident solar radiation (TISR), ERA5-compatible.

Counterpart of `gencast_tpu.ops.solar`: the radiation integrated over the
trailing hour (ERA5's `tisr`) from the orbital formulas of the ERA5/IFS
radiation code, the yearly total solar irradiance table ERA5 uses, and a
trapezoid over 360 bins. As there, each timestamp is split on the host in
float64 into whole days and a day fraction since J2000, and everything
after runs in float32 on the device the caller names, so the hour angle
keeps sub-second precision. A 1-degree frame is 65,160 points x 361 bins,
a 0.25-degree frame 375 M evaluations: `tisr_for_grid` takes the bins of a
band of latitude rows at a time, so no more than `max_elements` of them
are held at once.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

_SECONDS_PER_DAY = 60 * 60 * 24
# Unix epoch (1970-01-01T00) in days relative to J2000 (2000-01-01T12 TT).
_UNIX_TO_J2000_DAYS = -10957.5
_JULIAN_YEAR_DAYS = 365.25

# Reference TSI in W/m^2 when no table is supplied.
REFERENCE_TSI = 1361.0


def era5_tsi_table() -> Tuple[np.ndarray, np.ndarray]:
  """(years, tsi): the yearly total solar irradiance ERA5 uses (IFS cycle
  41r2, scaled by 0.9965), years as fractional calendar years."""
  years = np.arange(1951.5, 2035.5, 1.0)
  cycle = [1365.6121, 1365.7399, 1366.1021, 1366.3851, 1366.6836,
           1366.6022, 1366.6807, 1366.2300, 1366.0480, 1365.8545,
           1365.8107, 1365.7240, 1365.6918]
  tsi = 0.9965 * np.array(
      [1365.7765, 1365.7676, 1365.6284, 1365.6564, 1365.7773,
       1366.3109, 1366.6681, 1366.6328, 1366.3828, 1366.2767,
       1365.9199, 1365.7484, 1365.6963, 1365.6976, 1365.7341,
       1365.9178, 1366.1143, 1366.1644, 1366.2476, 1366.2426,
       1365.9580, 1366.0525, 1365.7991, 1365.7271, 1365.5345,
       1365.6453, 1365.8331, 1366.2747, 1366.6348, 1366.6482,
       1366.6951, 1366.2859, 1366.1992, 1365.8103, 1365.6416,
       1365.6379, 1365.7899, 1366.0826, 1366.6479, 1366.5533,
       1366.4457, 1366.3021, 1366.0286, 1365.7971, 1365.6996]
      + cycle * 3)
  return years, tsi


def seconds_to_fractional_year(seconds_since_epoch: np.ndarray) -> np.ndarray:
  """Approximate fractional calendar year (e.g. 2020.5) for the TSI table."""
  days = np.asarray(seconds_since_epoch, dtype=np.float64) / _SECONDS_PER_DAY
  return 1970.0 + days / 365.2425


def tsi_for_times(seconds_since_epoch, table=None) -> np.ndarray:
  """The TSI (W/m^2) of each timestamp, interpolated in the yearly table
  (constant past its ends), as float32 (the reference interpolates in
  float32)."""
  years_tab, tsi_tab = era5_tsi_table() if table is None else table
  years = seconds_to_fractional_year(np.asarray(seconds_since_epoch))
  return np.interp(years.astype(np.float32), np.float32(years_tab),
                   np.float32(tsi_tab)).astype(np.float32)


def _orbital_parameters(days_int: torch.Tensor, day_frac: torch.Tensor):
  """Rotational phase, sin and cos of the declination, the equation of time
  (s) and the Earth-Sun distance (AU), from whole days and day fraction
  since J2000 (float32 tensors that broadcast together)."""
  theta = (days_int + day_frac) / _JULIAN_YEAR_DAYS
  rotational_phase = torch.remainder(day_frac, 1.0)

  rel = 1.7535 + 6.283076 * theta
  rem = 6.240041 + 6.283020 * theta
  rlls = 4.8951 + 6.283076 * theta

  # Ecliptic longitude of the Sun.
  rllls = (4.8952 + 6.283320 * theta - 0.0075 * torch.sin(rel)
           - 0.0326 * torch.cos(rel) - 0.0003 * torch.sin(2.0 * rel)
           + 0.0002 * torch.cos(2.0 * rel))

  # Axial tilt (23.4393 degrees).
  repsm = 0.409093
  sin_declination = math.sin(repsm) * torch.sin(rllls)
  cos_declination = torch.sqrt(1.0 - sin_declination ** 2)

  eq_of_time_seconds = (591.8 * torch.sin(2.0 * rlls) - 459.4 * torch.sin(rem)
                        + 39.5 * torch.sin(rem) * torch.cos(2.0 * rlls)
                        - 12.7 * torch.sin(4.0 * rlls)
                        - 4.8 * torch.sin(2.0 * rem))

  solar_distance_au = (1.0001 - 0.0163 * torch.sin(rel)
                       + 0.0037 * torch.cos(rel))
  return (rotational_phase, sin_declination, cos_declination,
          eq_of_time_seconds, solar_distance_au)


def radiation_flux(days_int, day_frac, sin_lat, cos_lat, lon_rad, tsi):
  """The instantaneous TOA flux in W/m^2; the tensors broadcast together."""
  (rot, sin_dec, cos_dec, eqt, dist) = _orbital_parameters(days_int,
                                                           day_frac)
  solar_time = rot + eqt / _SECONDS_PER_DAY
  hour_angle = 2.0 * math.pi * solar_time + lon_rad
  sin_altitude = (cos_lat * cos_dec * torch.cos(hour_angle)
                  + sin_lat * sin_dec)
  return tsi * (1.0 / dist) ** 2 * torch.clamp(sin_altitude, min=0.0)


def integrated_radiation(days_int, day_frac, sin_lat, cos_lat, lon_rad, tsi,
                         integration_period_s: int = 3600,
                         num_bins: int = 360) -> torch.Tensor:
  """TOA radiation integrated over the trailing period (J/m^2): the
  trapezoid over num_bins of the flux; timestamps are the periods' END
  times (ERA5's convention). The tensors broadcast together; the bins are
  a new last axis, summed away."""
  offsets = torch.linspace(-integration_period_s / _SECONDS_PER_DAY, 0.0,
                           num_bins + 1, dtype=torch.float32,
                           device=day_frac.device)
  fluxes = radiation_flux(
      days_int[..., None], day_frac[..., None] + offsets,
      sin_lat[..., None], cos_lat[..., None], lon_rad[..., None],
      tsi[..., None])
  dx = integration_period_s / num_bins
  return torch.trapezoid(fluxes, dx=dx, dim=-1)


def tisr_for_grid(seconds_since_epoch: np.ndarray,
                  lat_deg: np.ndarray, lon_deg: np.ndarray,
                  integration_period_s: int = 3600,
                  num_bins: int = 360,
                  tsi: Optional[np.ndarray] = None,
                  device: torch.device | str = 'cpu',
                  max_elements: int = 1 << 25) -> torch.Tensor:
  """TISR fields [T, lat, lon] (float32, J/m^2, on `device`) at timestamps
  that are integration-period end times in seconds since the Unix epoch
  (ERA5's `tisr`). Computed frame by frame, in bands of latitude rows of at
  most `max_elements` point-bins."""
  secs = np.asarray(seconds_since_epoch, dtype=np.float64).reshape(-1)
  # Whole days and day fraction on the host in float64 (exact), so the
  # float32 device math keeps sub-second phase precision.
  days = secs / _SECONDS_PER_DAY + _UNIX_TO_J2000_DAYS
  days_int = np.floor(days)
  day_frac = days - days_int
  if tsi is None:
    tsi = tsi_for_times(secs)
  lat = np.deg2rad(np.asarray(lat_deg, np.float64))
  lon = np.deg2rad(np.asarray(lon_deg, np.float64))

  def put(x):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)

  sin_lat, cos_lat = put(np.sin(lat))[:, None], put(np.cos(lat))[:, None]
  lon_b = put(lon)[None, :]
  days_t, frac_t, tsi_t = put(days_int), put(day_frac), put(tsi)
  rows = max(1, max_elements // (lon.size * (num_bins + 1)))
  out = torch.empty((secs.size, lat.size, lon.size), dtype=torch.float32,
                    device=device)
  for t in range(secs.size):
    for lo in range(0, lat.size, rows):
      hi = min(lo + rows, lat.size)
      out[t, lo:hi] = integrated_radiation(
          days_t[t], frac_t[t], sin_lat[lo:hi], cos_lat[lo:hi], lon_b,
          tsi_t[t], integration_period_s=integration_period_s,
          num_bins=num_bins)
  return out
