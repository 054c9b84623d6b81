"""Training data sources: synthetic weather, windowing, batching, stats.

Counterpart of `gencast_tpu.data.sources` (numpy, host side), array for
array: `WindowedSource` packs raw per-variable fields into sample windows
of `num_input_frames` input frames, one (or more) target frames and the
target-time forcings; `SyntheticSource` generates physically-flavored
fields deterministically per (seed, index); `selection_stream`,
`batch_iterator` and `compute_stats` batch them and compute normalization
statistics. The ERA5 sources and the stats files are not carried over yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence

import numpy as np

from gencast_tpu_torch.data import forcings as forcings_lib
from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data import registry


@dataclasses.dataclass
class SampleWindow:
  """One training/eval sample in packed form (numpy, host)."""
  inputs: np.ndarray    # [num_input_frames..., folded to [lat, lon, C_in]]
  targets: np.ndarray   # [lat, lon, C_tgt] (or [K, lat, lon, C_tgt])
  forcings: np.ndarray  # [lat, lon, C_frc] (or [K, lat, lon, C_frc])
  timestamp: float      # seconds since epoch of the first target frame


class WindowedSource:
  """Base: provides packing of raw per-variable fields into sample windows."""

  def __init__(self, task: registry.TaskSpec, lat: np.ndarray,
               lon: np.ndarray, step_seconds: float = 12 * 3600):
    self.task = task
    self.lat = np.asarray(lat, np.float32)
    self.lon = np.asarray(lon, np.float32)
    self.step_seconds = step_seconds
    self.input_layout = layout_lib.build_layout(
        task.input_variables, task.pressure_levels, task.num_input_frames)
    self.target_layout = layout_lib.build_layout(
        task.target_variables, task.pressure_levels, 1)
    self.forcing_layout = layout_lib.build_layout(
        task.forcing_variables, task.pressure_levels, 1)

  # -- to be provided by subclasses --

  def field(self, name: str, times: np.ndarray) -> np.ndarray:
    """Raw field values: statics [lat, lon]; surface [T, lat, lon];
    atmospheric [T, L, lat, lon]."""
    raise NotImplementedError

  def timestamps(self) -> np.ndarray:
    raise NotImplementedError

  # -- windowing --

  def __len__(self) -> int:
    t = self.timestamps()
    return max(0, len(t) - self.task.num_input_frames)

  def _pack(self, names: Sequence[str], layout, times: np.ndarray
            ) -> np.ndarray:
    parts = []
    for name in layout.var_names:
      x = self.field(name, times)
      if registry.is_static(name):
        parts.append(x[:, :, None])
      elif registry.is_atmospheric(name):
        t, l = x.shape[0], x.shape[1]
        parts.append(np.moveaxis(x, (0, 1), (2, 3)).reshape(
            x.shape[2], x.shape[3], t * l))
      else:
        parts.append(np.moveaxis(x, 0, 2))
    return np.concatenate(parts, axis=-1).astype(np.float32)

  def sample(self, index: int, num_target_frames: int = 1) -> SampleWindow:
    t = self.timestamps()
    nin = self.task.num_input_frames
    in_times = t[index:index + nin]
    tgt_times = t[index + nin:index + nin + num_target_frames]
    if len(tgt_times) < num_target_frames:
      raise IndexError(index)

    inputs = self._pack(self.task.input_variables, self.input_layout,
                        in_times)
    tgt_list, frc_list = [], []
    for tt in tgt_times:
      tgt_list.append(self._pack(self.task.target_variables,
                                 self.target_layout, np.array([tt])))
      frc_list.append(self._pack(self.task.forcing_variables,
                                 self.forcing_layout, np.array([tt])))
    targets = tgt_list[0] if num_target_frames == 1 else np.stack(tgt_list)
    frcs = frc_list[0] if num_target_frames == 1 else np.stack(frc_list)
    return SampleWindow(inputs=inputs, targets=targets, forcings=frcs,
                        timestamp=float(tgt_times[0]))


class SyntheticSource(WindowedSource):
  """Deterministic synthetic weather with plausible structure.

  Each variable is a smooth function of latitude plus seasonal and diurnal
  harmonics plus low-wavenumber noise that evolves smoothly in time, so
  residual statistics and normalization behave like real data.
  """

  def __init__(self, task: registry.TaskSpec, lat: np.ndarray,
               lon: np.ndarray, num_times: int = 40,
               start_seconds: float = 1.0e9, seed: int = 0,
               step_seconds: float = 12 * 3600):
    super().__init__(task, lat, lon, step_seconds)
    self._times = start_seconds + step_seconds * np.arange(num_times)
    self._seed = seed
    self._forcing_names = set(registry.FORCING_VARS)
    self._cache: Dict[str, np.ndarray] = {}

  def timestamps(self) -> np.ndarray:
    return self._times

  def _base_noise(self, name: str) -> np.ndarray:
    """Smooth [num_times, lat, lon] noise, cached per variable."""
    if name not in self._cache:
      import zlib
      rng = np.random.default_rng(
          zlib.crc32(name.encode()) ^ (self._seed & 0x7FFFFFFF))
      nlat, nlon = self.lat.size, self.lon.size
      # Low-wavenumber Fourier noise, AR(1) in time.
      kmax = 4
      t = len(self._times)
      coeffs = rng.standard_normal((t, 2 * kmax + 1, 2 * kmax + 1))
      for i in range(1, t):
        coeffs[i] = 0.9 * coeffs[i - 1] + np.sqrt(1 - 0.81) * coeffs[i]
      phi = np.deg2rad(self.lon)
      mu = np.deg2rad(self.lat)
      # cos(a*2mu + b*phi) = cosA cosB - sinA sinB: two small einsums
      # instead of a python loop over (2k+1)^2 full-grid basis fields
      # (the loop took ~30 min at 0.25 degrees; this takes seconds).
      wav = np.arange(-kmax, kmax + 1, dtype=np.float32)
      arg_lat = wav[:, None] * 2.0 * mu[None, :].astype(np.float32)
      arg_lon = wav[:, None] * phi[None, :].astype(np.float32)
      c32 = coeffs.astype(np.float32)
      n_modes = 2 * kmax + 1

      def synth(lat_basis, lon_basis):  # [A,lat],[B,lon] -> [t,lat,lon]
        tmp = np.tensordot(c32, lat_basis, axes=([1], [0]))  # [t, B, lat]
        tmp = np.ascontiguousarray(tmp.transpose(0, 2, 1))   # [t, lat, B]
        return (tmp.reshape(t * nlat, n_modes) @ lon_basis
                ).reshape(t, nlat, nlon)

      field = (synth(np.cos(arg_lat), np.cos(arg_lon))
               - synth(np.sin(arg_lat), np.sin(arg_lon)))
      field /= np.sqrt((2 * kmax + 1) ** 2 / 2)
      self._cache[name] = field.astype(np.float32)
    return self._cache[name]

  def field(self, name: str, times: np.ndarray) -> np.ndarray:
    nlat, nlon = self.lat.size, self.lon.size
    if name in self._forcing_names:
      vals = forcings_lib.all_forcings(times, self.lat, self.lon, (name,))
      return vals[name]
    if name == 'land_sea_mask':
      rng = np.random.default_rng(self._seed + 7)
      return (rng.random((nlat, nlon)) > 0.7).astype(np.float32)
    if name == 'geopotential_at_surface':
      rng = np.random.default_rng(self._seed + 8)
      return (2000.0 * np.abs(rng.standard_normal((nlat, nlon)))
              ).astype(np.float32)

    idx = np.searchsorted(self._times, times)
    noise = self._base_noise(name)[idx]  # [T, lat, lon]
    latf = np.cos(np.deg2rad(self.lat))[None, :, None]
    season = np.sin(2 * np.pi * forcings_lib.year_progress(times)
                    )[:, None, None]

    if registry.is_atmospheric(name):
      levels = np.asarray(self.task.pressure_levels, np.float64)
      lev_profile = np.log(levels / levels.max())[None, :, None, None]
      base = {'temperature': 250.0, 'geopotential': 50000.0,
              'u_component_of_wind': 10.0, 'v_component_of_wind': 0.0,
              'vertical_velocity': 0.0, 'specific_humidity': 0.002}
      scale = {'temperature': 30.0, 'geopotential': 20000.0,
               'u_component_of_wind': 15.0, 'v_component_of_wind': 8.0,
               'vertical_velocity': 0.3, 'specific_humidity': 0.002}
      b = base.get(name, 0.0)
      s = scale.get(name, 1.0)
      out = (b - s * lev_profile * 0.3
             + s * (0.5 * latf + 0.2 * season + 0.3 * noise)[:, None])
      return out.astype(np.float32)

    base = {'2m_temperature': 285.0, 'mean_sea_level_pressure': 101000.0,
            '10m_u_component_of_wind': 0.0, '10m_v_component_of_wind': 0.0,
            'sea_surface_temperature': 290.0,
            'total_precipitation_12hr': 0.001,
            'total_precipitation_6hr': 0.0005}
    scale = {'2m_temperature': 20.0, 'mean_sea_level_pressure': 2000.0,
             '10m_u_component_of_wind': 5.0, '10m_v_component_of_wind': 5.0,
             'sea_surface_temperature': 10.0,
             'total_precipitation_12hr': 0.002,
             'total_precipitation_6hr': 0.001}
    b = base.get(name, 0.0)
    s = scale.get(name, 1.0)
    out = b + s * (0.6 * latf + 0.3 * season + 0.4 * noise)
    if name.startswith('total_precipitation'):
      out = np.maximum(out - b, 0.0)
    if name == 'sea_surface_temperature':
      lsm = self.field('land_sea_mask', times)
      out = np.where(lsm[None] > 0.5, np.nan, out)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Batching & statistics.
# ---------------------------------------------------------------------------


def selection_stream(n: int, batch_size: int, *, shuffle: bool = True,
                     seed: int = 0, loop: bool = True,
                     rows=None) -> Iterator[np.ndarray]:
  """The window-index selection stream behind `batch_iterator`.

  Yields one array of window indices per batch. Shared with the
  out-of-process `data.workers.ParallelBatchIterator` so the two iterators
  stay bitwise-identical by construction (same seed -> same permutations
  -> same selections), not by hand-maintained duplication.

  rows: optional sequence of batch-row positions to materialize (multi-
  host training: each process packs only the rows its devices own). The
  global permutation stream is drawn identically regardless of rows, so
  processes slicing different rows of the same seed see one consistent
  global batch — and pay only their share of the host packing cost.
  """
  if n == 0 or batch_size > n:
    raise ValueError(
        f'source has {n} sample windows; cannot serve batch_size='
        f'{batch_size}')
  if rows is not None:
    rows = np.asarray(rows)
    if rows.size == 0:
      # A dp/mp layout can leave a process with no 'data' shard; fail with
      # the cause rather than np.stack's opaque 'need at least one array'.
      raise ValueError(
          'rows is empty: this process owns no batch rows under the '
          'requested data-parallel layout (see meshes.local_batch_plan)')
  rng = np.random.default_rng(seed)
  while True:
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n - batch_size + 1, batch_size):
      sel = idx[start:start + batch_size]
      if rows is not None:
        sel = sel[rows]
      yield sel
    if not loop:
      return


def batch_iterator(source: WindowedSource, batch_size: int, *,
                   shuffle: bool = True, seed: int = 0,
                   loop: bool = True,
                   rows=None) -> Iterator[Dict[str, np.ndarray]]:
  """Yields dicts of stacked numpy batches: inputs/targets/forcings.

  See `selection_stream` for the rows (multi-host) semantics.
  """
  for sel in selection_stream(len(source), batch_size, shuffle=shuffle,
                              seed=seed, loop=loop, rows=rows):
    ws = [source.sample(int(i)) for i in sel]
    yield {
        'inputs': np.stack([w.inputs for w in ws]),
        'targets': np.stack([w.targets for w in ws]),
        'forcings': np.stack([w.forcings for w in ws]),
    }


def compute_stats(source: WindowedSource,
                  max_samples: int = 50) -> layout_lib.Stats:
  """Per-(variable, level) mean/std and 1-step-difference std from data —
  the normalization statistics the reference loads from its stats/ files."""
  task = source.task
  times = source.timestamps()[:max_samples + 1]
  names = sorted(set(task.input_variables) | set(task.target_variables))
  mean, std, diffs = {}, {}, {}
  for name in names:
    if registry.is_static(name):
      x = source.field(name, times[:1])
      mean[name] = np.asarray(np.nanmean(x))
      std[name] = np.asarray(max(float(np.nanstd(x)), 1e-6))
      diffs[name] = np.asarray(1.0)
      continue
    x = source.field(name, times)  # [T, (L,) lat, lon]
    if registry.is_atmospheric(name):
      axes = (0, 2, 3)
    else:
      axes = (0, 1, 2)
    mean[name] = np.nanmean(x, axis=axes)
    std[name] = np.maximum(np.nanstd(x, axis=axes), 1e-6)
    d = np.diff(x, axis=0)
    diffs[name] = np.maximum(np.nanstd(d, axis=tuple(a for a in axes)),
                             1e-6)
  return layout_lib.Stats(mean=mean, std=std, diffs_std=diffs)
