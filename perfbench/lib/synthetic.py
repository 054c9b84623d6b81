"""Synthetic weather and its statistics, made on the device from a seed.

The structure of the program's `data.sources.SyntheticSource`, frozen here
so that a later change cannot move the yardstick, and made in a few large
device calls instead of field by field on the host: each variable (and
pressure level) is its climatological mean plus its standard deviation
times a smooth function of latitude and low-wavenumber noise (zonal and
meridional wavenumbers up to 4) that evolves from frame to frame as an
AR(1) process (coefficient 0.9). A window is three frames 12 hours apart:
the two input frames and the target. The land-sea mask is a smooth field
thresholded to 30% land, sea-surface temperature is missing (NaN) over land,
precipitation is not negative, and the day- and year-progress forcings are
those of a time drawn from the seed. The statistics are per-variable tables
jittered by up to 10% from the seed; the 12-hour difference deviations
follow from the AR(1) coefficient.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.lib import seeds
from perfbench.reference import layout as layout_lib

_MEAN_STD = {
    '2m_temperature': (285.0, 20.0),
    'mean_sea_level_pressure': (101000.0, 2000.0),
    '10m_u_component_of_wind': (0.0, 5.0),
    '10m_v_component_of_wind': (0.0, 5.0),
    'sea_surface_temperature': (290.0, 10.0),
    'total_precipitation_12hr': (0.001, 0.002),
    'temperature': (250.0, 30.0),
    'geopotential': (50000.0, 20000.0),
    'u_component_of_wind': (10.0, 15.0),
    'v_component_of_wind': (0.0, 8.0),
    'vertical_velocity': (0.0, 0.3),
    'specific_humidity': (0.002, 0.002),
    'geopotential_at_surface': (2000.0, 2000.0),
    'land_sea_mask': (0.3, 0.45),
    'year_progress_sin': (0.0, 0.7),
    'year_progress_cos': (0.0, 0.7),
    'day_progress_sin': (0.0, 0.7),
    'day_progress_cos': (0.0, 0.7),
}
_AR = 0.9
_KMAX = 4
_FORCINGS = ('year_progress_sin', 'year_progress_cos', 'day_progress_sin',
             'day_progress_cos')


def stats(config: dict, seed: int) -> dict:
  """{'mean', 'std', 'diffs_std'}: {variable: scalar or [levels]}."""
  r = seeds.rng(seed, seeds.STATS)
  levels = np.asarray(config['pressure_levels'], np.float64)
  names = sorted(set(config['input_variables']) | set(
      config['target_variables']) | set(config['forcing_variables']))
  out = {'mean': {}, 'std': {}, 'diffs_std': {}}
  for name in names:
    m, s = _MEAN_STD[name]
    if name in layout_lib.ATMOSPHERIC:
      profile = np.log(levels / levels.max())
      mean = m - 0.3 * s * profile
      std = s * (1.0 + 0.1 * r.uniform(-1, 1, levels.shape))
    else:
      mean = np.asarray(m)
      std = np.asarray(s * (1.0 + 0.1 * r.uniform(-1, 1)))
    out['mean'][name] = np.asarray(mean, np.float32)
    out['std'][name] = np.asarray(std, np.float32)
    out['diffs_std'][name] = np.asarray(
        std * 0.4 * math.sqrt(2 * (1 - _AR)), np.float32)
  return out


class Weather:
  """Windows of synthetic weather for one configuration, on `device`."""

  def __init__(self, config: dict, stat: dict, device):
    self.cfg = config
    self.stats = stat
    self.task = layout_lib.task(config)
    self.device = torch.device(device)
    lat = np.deg2rad(np.arange(-90.0, 90.0 + config['resolution_deg'] / 2,
                               config['resolution_deg']))
    lon = np.deg2rad(np.arange(0.0, 360.0, config['resolution_deg']))
    self.num_lat, self.num_lon = lat.size, lon.size
    wav = np.arange(-_KMAX, _KMAX + 1, dtype=np.float64)
    a_lat = wav[:, None] * 2.0 * lat[None]
    a_lon = wav[:, None] * lon[None]
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    self.basis = (t(np.cos(a_lat)), t(np.cos(a_lon)), t(np.sin(a_lat)),
                  t(np.sin(a_lon)))
    self.coslat = t(np.cos(lat))[:, None]
    self.lon = t(lon)[None, :]
    # Field rows: one per variable and level of the inputs and targets.
    self.rows: Dict[Tuple[str, int], int] = {}
    for lay in (self.task.inputs, self.task.targets):
      for c in range(lay.num_channels):
        key = (lay.names[lay.var[c]], int(lay.level[c]))
        self.rows.setdefault(key, len(self.rows))

  def _noise(self, gen: torch.Generator, rows: int, frames: int
             ) -> torch.Tensor:
    """[rows, frames, lat, lon], unit variance, AR(1) over the frames."""
    n = 2 * _KMAX + 1
    c = torch.randn((rows, frames, n, n), generator=gen,
                    device=self.device)
    for f in range(1, frames):
      c[:, f] = _AR * c[:, f - 1] + math.sqrt(1 - _AR ** 2) * c[:, f]
    cl, co, sl, so = self.basis
    field = (torch.einsum('rfab,ai,bj->rfij', c, cl, co)
             - torch.einsum('rfab,ai,bj->rfij', c, sl, so))
    return field / math.sqrt(n * n / 2)

  def window(self, seed: int) -> Tuple[torch.Tensor, ...]:
    """(inputs [lat, lon, C_in], targets [lat, lon, C_t], forcings
    [lat, lon, C_f]), raw float32, from `seed`."""
    gen = torch.Generator(device=self.device).manual_seed(seed)
    frames = self.cfg['num_input_frames'] + 1
    noise = self._noise(gen, len(self.rows) + 1, frames)
    land = self._noise(gen, 1, 1)[0, 0] > 0.52
    hours = float(torch.randint(0, 24 * 365 * 40, (1,), generator=gen,
                                device=self.device)) * 1.0
    lat_term = 0.6 * self.coslat - 0.4
    sd, st = self.stats['mean'], self.stats['std']

    def value(name: str, level: int, frame: int) -> torch.Tensor:
      if name in _FORCINGS:
        h = hours + 12.0 * (frame - (frames - 2))
        year = 2 * math.pi * (h / (24 * 365.2425) % 1.0)
        day = 2 * math.pi * ((h / 24.0) % 1.0) + self.lon
        v = {'year_progress_sin': math.sin(year) + 0 * self.lon,
             'year_progress_cos': math.cos(year) + 0 * self.lon,
             'day_progress_sin': torch.sin(day),
             'day_progress_cos': torch.cos(day)}[name]
        return v.expand(self.num_lat, self.num_lon)
      if name == 'land_sea_mask':
        return land.float()
      mean = np.asarray(sd[name])
      std = np.asarray(st[name])
      if level >= 0:
        mean, std = mean[level], std[level]
      row = self.rows[(name, level)]
      f = lat_term + 0.4 * noise[row, 0 if name in layout_lib.STATIC
                                 else frame]
      x = float(mean) + float(std) * f
      if name.startswith('total_precipitation'):
        x = torch.clamp(x, min=0.0)
      if name == 'sea_surface_temperature':
        x = torch.where(land, torch.full_like(x, float('nan')), x)
      return x

    def pack(lay: layout_lib.Layout, first_frame: int) -> torch.Tensor:
      return torch.stack([
          value(lay.names[lay.var[c]], int(lay.level[c]),
                first_frame + int(lay.time[c]))
          for c in range(lay.num_channels)], dim=-1)

    last = frames - 1
    return (pack(self.task.inputs, 0), pack(self.task.targets, last),
            pack(self.task.forcings, last))
