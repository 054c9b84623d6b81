"""Channel layouts of the plain reference.

A packed field [lat, lon, C] holds its variables in sorted order, each
variable's frames time-major and its pressure levels level-minor; statics
take one channel. The denoiser's conditioning is the forcings and the noisy
targets merged into one such layout. Per-channel normalization vectors,
residual bases and loss weights follow from the layouts and the statistics,
as GenCast's wrappers and loss define them (Price et al. 2024, section
on training; DeepMind's gencast package: normalization.py, losses.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

ATMOSPHERIC = frozenset((
    'potential_vorticity', 'specific_rain_water_content',
    'specific_snow_water_content', 'geopotential', 'temperature',
    'u_component_of_wind', 'v_component_of_wind', 'specific_humidity',
    'vertical_velocity', 'vorticity', 'divergence', 'relative_humidity',
    'ozone_mass_mixing_ratio', 'specific_cloud_liquid_water_content',
    'specific_cloud_ice_water_content', 'fraction_of_cloud_cover'))
STATIC = frozenset(('geopotential_at_surface', 'land_sea_mask'))

# Loss weight of each surface target; atmospheric targets weigh 1.
SURFACE_LOSS_WEIGHTS = {
    '2m_temperature': 1.0, '10m_u_component_of_wind': 0.1,
    '10m_v_component_of_wind': 0.1, 'mean_sea_level_pressure': 0.1,
    'sea_surface_temperature': 0.1, 'total_precipitation_12hr': 0.1}


@dataclasses.dataclass(frozen=True)
class Layout:
  names: Tuple[str, ...]
  levels: Tuple[int, ...]
  var: np.ndarray    # [C] index into names
  time: np.ndarray   # [C]
  level: np.ndarray  # [C] index into levels, -1 for a surface or static

  @property
  def num_channels(self) -> int:
    return self.var.shape[0]

  def channels(self, name: str) -> np.ndarray:
    return np.nonzero(self.var == self.names.index(name))[0]


def layout(names: Sequence[str], levels: Sequence[int], times: int) -> Layout:
  names = tuple(sorted(set(names)))
  v, t, lv = [], [], []
  for i, name in enumerate(names):
    for f in range(1 if name in STATIC else times):
      for lev in (range(len(levels)) if name in ATMOSPHERIC else [-1]):
        v.append(i)
        t.append(f)
        lv.append(lev)
  return Layout(names, tuple(levels), np.asarray(v), np.asarray(t),
                np.asarray(lv))


def find(lay: Layout, name: str, time: int, level: int) -> int:
  if name not in lay.names:
    return -1
  m = np.nonzero((lay.var == lay.names.index(name)) & (lay.time == time)
                 & (lay.level == level))[0]
  return int(m[0]) if m.size else -1


def merged_order(a: Layout, b: Layout) -> Tuple[Layout, np.ndarray]:
  """The layout of a's and b's variables together, and for each of its
  channels the channel of concat([a, b]) that holds it."""
  merged = layout(a.names + b.names, a.levels, 1)
  perm = np.empty(merged.num_channels, dtype=np.int64)
  for c in range(merged.num_channels):
    name = merged.names[merged.var[c]]
    src, off = (a, 0) if name in a.names else (b, a.num_channels)
    perm[c] = off + find(src, name, merged.time[c], merged.level[c])
  return merged, perm


@dataclasses.dataclass(frozen=True)
class Task:
  inputs: Layout
  targets: Layout
  forcings: Layout
  cond: Layout
  cond_perm: np.ndarray  # concat([forcings, noisy targets]) -> cond


def task(config: dict) -> Task:
  levels = tuple(config['pressure_levels'])
  inputs = layout(config['input_variables'], levels,
                  config['num_input_frames'])
  targets = layout(config['target_variables'], levels, 1)
  forcings = layout(config['forcing_variables'], levels, 1)
  cond, perm = merged_order(forcings, targets)
  return Task(inputs, targets, forcings, cond, perm)


def per_channel(lay: Layout, table: Dict[str, np.ndarray], default: float
                ) -> np.ndarray:
  out = np.full(lay.num_channels, default, dtype=np.float32)
  for c in range(lay.num_channels):
    name = lay.names[lay.var[c]]
    if name in table:
      v = np.asarray(table[name])
      out[c] = v if v.ndim == 0 else v[lay.level[c]]
  return out


@dataclasses.dataclass(frozen=True)
class Normalization:
  """Per-channel vectors (float32): inputs and forcings are normalized by
  their mean and standard deviation; a target that is also an input is
  predicted as its change from the last input frame over the standard
  deviation of 12-hour differences, any other target by its mean and
  deviation."""
  in_loc: np.ndarray
  in_scale: np.ndarray
  frc_loc: np.ndarray
  frc_scale: np.ndarray
  tgt_loc: np.ndarray
  tgt_scale: np.ndarray
  residual_from: np.ndarray  # [C_t] input channel of the base, or -1


def normalization(t: Task, stats: dict) -> Normalization:
  mean, std, diffs = stats['mean'], stats['std'], stats['diffs_std']
  last = t.inputs.time.max()
  res = np.full(t.targets.num_channels, -1, dtype=np.int64)
  for c in range(t.targets.num_channels):
    name = t.targets.names[t.targets.var[c]]
    res[c] = find(t.inputs, name, 0 if name in STATIC else last,
                  t.targets.level[c])
  has = res >= 0
  return Normalization(
      in_loc=per_channel(t.inputs, mean, 0.0),
      in_scale=per_channel(t.inputs, std, 1.0),
      frc_loc=per_channel(t.forcings, mean, 0.0),
      frc_scale=per_channel(t.forcings, std, 1.0),
      tgt_loc=np.where(has, 0.0, per_channel(t.targets, mean, 0.0)
                       ).astype(np.float32),
      tgt_scale=np.where(has, per_channel(t.targets, diffs, 1.0),
                         per_channel(t.targets, std, 1.0)
                         ).astype(np.float32),
      residual_from=res)


def loss_weights(lay: Layout) -> np.ndarray:
  """[C]: the variable's weight times its level's (pressure over the mean
  pressure) over the variable's channel count, so that the weighted sum of
  channel errors is the weighted sum over variables of their level-weighted
  means."""
  levels = np.asarray(lay.levels, dtype=np.float64)
  level_w = levels / levels.mean()
  counts = np.bincount(lay.var, minlength=len(lay.names))
  out = np.zeros(lay.num_channels, dtype=np.float32)
  for c in range(lay.num_channels):
    name = lay.names[lay.var[c]]
    lw = float(level_w[lay.level[c]]) if lay.level[c] >= 0 else 1.0
    out[c] = SURFACE_LOSS_WEIGHTS.get(name, 1.0) * lw / counts[lay.var[c]]
  return out


def latitude_weights(lat_deg: np.ndarray) -> np.ndarray:
  """Unit-mean cell areas per latitude row of a grid with pole rows."""
  lat = np.asarray(lat_deg, dtype=np.float64)
  dlat = abs(lat[1] - lat[0])
  w = np.cos(np.deg2rad(lat)) * np.sin(np.deg2rad(dlat / 2))
  w[np.isclose(np.abs(lat), 90.0)] = np.sin(np.deg2rad(dlat / 4)) ** 2
  return (w / w.mean()).astype(np.float32)
