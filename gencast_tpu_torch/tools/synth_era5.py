"""Synthesizes an ERA5-format monthly corpus for end-to-end runs.

Counterpart of the repository's `tools/synth_era5.py`: the same fields from
the same seed. `--layout netcdf` (the default) writes, through the port's
writer (h5py), the file layout `data/era5_netcdf.py` parses (the reference
CDS download layout, training/era5_dataset.py:43-345):

  era5_pressure_levels_YYYYMM_<res>deg.nc   (t/z/u/v/w/q on levels)
  era5_single_levels_YYYYMM_<res>deg.nc     (t2m/msl/u10/v10/sst/tp)
  era5_static_<res>deg.nc                   (lsm, surface z)

`--layout npz` writes, with numpy alone, the `sources.Era5NpzSource`
shards that `tools.convert_era5` makes of those files: the same decoding,
latitude flip and precipitation differencing applied to the arrays in
memory. It is how a machine without h5py gets an ERA5-format directory.

Fields are smooth, seasonally/diurnally structured and temporally
autocorrelated (an AR(1) walk over low-order spherical harmonics on top
of a deterministic climatology), so a model trained on them has real
signal to fit; the files look like a CDS download to the reader:
descending latitude (exercises the flip), int16-packed temperature
(exercises scale/offset decode), NaN-filled SST over land, cumulative
precipitation (exercises the 12h differencing).

Usage:
  python -m gencast_tpu_torch.tools.synth_era5 --out /path/to/era5_synth \
      --resolution 10.0 --months 202001 202002 --steps_per_month 40
  python -m gencast_tpu_torch.tools.synth_era5 --out /path/to/era5_npz \
      --resolution 1.0 --steps_per_month 6 --layout npz
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from gencast_tpu_torch.data import era5_netcdf, registry
from gencast_tpu_torch.data.registry import PRESSURE_LEVELS_WEATHERBENCH_13

LAYOUTS = ('netcdf', 'npz')
_TIME_UNITS = b'seconds since 1970-01-01'
_SST_FILL = np.float32(-32767.0)
_DIMS_SINGLE = ('valid_time', 'latitude', 'longitude')
_DIMS_PRESSURE = ('valid_time', 'pressure_level', 'latitude', 'longitude')


def _month_start_seconds(yyyymm: str) -> float:
  base = np.datetime64(f'{yyyymm[:4]}-{yyyymm[4:]}-01T00:00:00')
  return float((base - np.datetime64('1970-01-01T00:00:00'))
               / np.timedelta64(1, 's'))


class _FieldGen:
  """Smooth random fields with AR(1) time correlation.

  Each variable gets a fixed random set of low-order (lat, lon) harmonic
  modes; their amplitudes follow an AR(1) walk across time steps, giving
  12h-step autocorrelation ~rho so that persistence + learned dynamics
  both beat climatology (what a weather model needs to have signal).
  """

  def __init__(self, lat_deg, lon_deg, seed, num_modes=8, rho=0.95):
    rng = np.random.default_rng(seed)
    lat = np.deg2rad(lat_deg)[:, None]
    lon = np.deg2rad(lon_deg)[None, :]
    self._modes = []
    for _ in range(num_modes):
      kl = rng.integers(1, 4)
      km = rng.integers(1, 5)
      phase = rng.uniform(0, 2 * np.pi)
      self._modes.append(np.cos(kl * lat) * np.cos(km * lon + phase))
    self._modes = np.stack(self._modes)          # [M, lat, lon]
    self._rng = rng
    self._rho = rho
    self._amps = {}

  def step(self, name: str) -> np.ndarray:
    """Next time step's anomaly field for variable `name` (unit scale)."""
    a = self._amps.get(name)
    innov = self._rng.standard_normal(self._modes.shape[0])
    a = (innov if a is None
         else self._rho * a + np.sqrt(1 - self._rho ** 2) * innov)
    self._amps[name] = a
    return np.tensordot(a, self._modes, axes=1) / np.sqrt(len(a))


def synthesize_fields(resolution_deg: float, months: Sequence[str],
                      steps_per_month: int, levels: np.ndarray, seed: int,
                      step_seconds: float) -> Iterator[Tuple]:
  """The corpus as stored in the files, in the order it is drawn: first
  ('static', lat, lon, {raw name: [lat, lon]}), then per month
  (month, times, {raw name: single-level [T, lat, lon]},
  {raw name: pressure-level [T, L, lat, lon]}, t_scale, t_offset), with
  latitude descending, SST's land points at the fill value, 't' packed as
  int16 and 'tp' cumulative within the month."""
  lat = np.arange(90.0, -90.0 - 1e-6, -resolution_deg)  # ERA5: descending
  lon = np.arange(0.0, 360.0, resolution_deg)
  nlat, nlon, nlev = lat.size, lon.size, levels.size

  lat2 = np.deg2rad(lat)[:, None]
  coslat = np.cos(lat2)
  gen = _FieldGen(lat, lon, seed)

  # Static fields (shared by all months).
  lsm = (gen.step('lsm_shape') + 0.3 * np.sin(2 * lat2) > 0.1
         ).astype(np.float32)
  zs = np.maximum(gen.step('orography'), 0.0) * 2.0e4 * lsm
  yield ('static', lat, lon, {'lsm': lsm.astype(np.float32),
                              'z': zs.astype(np.float32)})

  # Standard-atmosphere-ish vertical structure.
  lev_frac = levels.astype(np.float64) / 1000.0          # 0.05 .. 1.0
  t_base = 210.0 + 80.0 * lev_frac                       # K
  z_base = 7000.0 * 9.80665 * np.log(1.0 / lev_frac + 1e-9)  # m^2/s^2
  q_base = 0.012 * lev_frac ** 3

  for month in months:
    t0 = _month_start_seconds(month)
    times = t0 + np.arange(steps_per_month) * step_seconds
    year_frac = 2 * np.pi * (times / (365.2425 * 86400.0) % 1.0)
    day_frac = 2 * np.pi * (times / 86400.0 % 1.0)

    def surf(name, base, amp, diurnal=0.0):
      out = np.empty((times.size, nlat, nlon), np.float32)
      for i in range(times.size):
        seasonal = amp * 0.3 * np.sin(year_frac[i]) * np.sin(lat2)
        diur = diurnal * np.cos(
            day_frac[i] + np.deg2rad(lon)[None, :]) * coslat
        out[i] = base + 20.0 * coslat * (amp / 30.0) + seasonal + diur \
            + amp * 0.25 * gen.step(name)
      return out

    single = {'t2m': surf('t2m', 278.0, 30.0, diurnal=4.0),
              'msl': surf('msl', 101325.0, 1500.0),
              'u10': surf('u10', 0.0, 8.0),
              'v10': surf('v10', 0.0, 6.0)}
    sst = surf('sst', 288.0, 10.0)
    sst[:, lsm > 0.5] = np.nan                           # NaN over land
    single['sst'] = np.where(np.isnan(sst), _SST_FILL, sst).astype(np.float32)
    # Cumulative precip within the month; the reader differences it.
    rate = np.maximum(surf('tp', 0.0, 1.0), 0.0) * 2e-3
    single['tp'] = np.cumsum(rate, axis=0).astype(np.float32)

    atmos = {}
    for name, base, amp in (('t', t_base, 12.0), ('z', z_base, 800.0),
                            ('u', 10.0 * (1 - lev_frac), 10.0),
                            ('v', np.zeros(nlev), 8.0),
                            ('w', np.zeros(nlev), 0.2),
                            ('q', q_base, 0.002)):
      x = np.empty((times.size, nlev, nlat, nlon), np.float32)
      for i in range(times.size):
        anom = gen.step(name)
        for j in range(nlev):
          b = base[j] if np.ndim(base) else base
          x[i, j] = b + amp * (0.5 + lev_frac[j]) * anom \
              + amp * 0.2 * np.sin(year_frac[i]) * np.sin(lat2)
      atmos[name] = x

    # Pack temperature as int16 to exercise scale/offset decoding.
    t_raw = atmos.pop('t')
    t_min, t_max = float(t_raw.min()), float(t_raw.max())
    scale = (t_max - t_min) / 60000.0 or 1.0
    atmos['t'] = np.round((t_raw - t_min) / scale - 30000.0).astype(np.int16)
    yield (month, times, single, atmos, np.float64(scale),
           np.float64(t_min + 30000.0 * scale))


def _write_netcdf(out_dir: str, res: str, levels: np.ndarray, seed: int,
                  fields: Iterator[Tuple]) -> None:
  """The corpus as CDS-download NetCDF files (h5py)."""
  import h5py

  from gencast_tpu_torch.data import netcdf_writer
  _, lat, lon, statics = next(fields)
  netcdf_writer.write_dataset(
      os.path.join(out_dir, f'era5_static_{res}.nc'),
      {'latitude': lat, 'longitude': lon},
      {name: (('latitude', 'longitude'), x) for name, x in statics.items()},
      global_attrs={'source': 'tools/synth_era5.py', 'seed': seed})
  for month, times, single, atmos, scale, offset in fields:
    single_path = os.path.join(out_dir,
                               f'era5_single_levels_{month}_{res}.nc')
    netcdf_writer.write_dataset(
        single_path,
        {'valid_time': times, 'latitude': lat, 'longitude': lon},
        {name: (_DIMS_SINGLE, single[name])
         for name in ('t2m', 'msl', 'u10', 'v10', 'sst', 'tp')},
        dim_attrs={'valid_time': {'units': _TIME_UNITS}})
    # Mark the SST fill value (decoded back to NaN by the reader).
    with h5py.File(single_path, 'a') as f:
      f['sst'].attrs['_FillValue'] = _SST_FILL

    pressure_path = os.path.join(out_dir,
                                 f'era5_pressure_levels_{month}_{res}.nc')
    netcdf_writer.write_dataset(
        pressure_path,
        {'valid_time': times, 'pressure_level': levels.astype(np.float64),
         'latitude': lat, 'longitude': lon},
        {name: (_DIMS_PRESSURE, atmos[name])
         for name in ('z', 'u', 'v', 'w', 'q', 't')},
        dim_attrs={'valid_time': {'units': _TIME_UNITS}})
    with h5py.File(pressure_path, 'a') as f:
      f['t'].attrs['scale_factor'] = scale
      f['t'].attrs['add_offset'] = offset
    print(f'[synth_era5] wrote {month}: {times.size} steps at {res}')


def _decoded(raw: Dict[str, np.ndarray], dims: Sequence[str],
             attrs: Dict[str, Dict]) -> Dict[str, Tuple]:
  """{raw name: (standardized dims, decoded array)} in the order the
  NetCDF reader meets them (HDF5 lists a file's names sorted)."""
  std_dims = [era5_netcdf.DIM_RENAMES.get(d, d) for d in dims]
  return {name: (std_dims, era5_netcdf.decode(raw[name],
                                              **attrs.get(name, {})))
          for name in sorted(raw)}


def _write_npz(out_dir: str, levels: np.ndarray,
               fields: Iterator[Tuple]) -> None:
  """The corpus as Era5NpzSource shards: what tools.convert_era5 writes
  for the NetCDF files of `_write_netcdf`, by the same standardization."""
  from gencast_tpu_torch.tools import convert_era5
  _, lat, lon, statics = next(fields)
  file_levels = levels.astype(np.float64)
  written = []
  for month, times, single, atmos, scale, offset in fields:
    data = era5_netcdf.standardize_month(
        _decoded(atmos, _DIMS_PRESSURE,
                 {'t': {'scale': scale, 'offset': offset}}),
        _decoded(single, _DIMS_SINGLE, {'sst': {'fill': _SST_FILL}}),
        lat, file_levels, levels=tuple(int(l) for l in levels))
    convert_era5.write_month_shard(
        out_dir, month, data, era5_netcdf.time_seconds(times, _TIME_UNITS))
    written.append(month)
  convert_era5.write_statics_and_manifest(
      out_dir,
      era5_netcdf.standardize_static(
          _decoded(statics, ('latitude', 'longitude'), {}), lat),
      np.sort(lat), lon, [int(l) for l in levels], written)


def synthesize(out_dir: str,
               resolution_deg: float = 10.0,
               months: Sequence[str] = ('202001',),
               steps_per_month: int = 40,
               levels: Sequence[int] = PRESSURE_LEVELS_WEATHERBENCH_13,
               seed: int = 0,
               step_seconds: float = 12 * 3600,
               layout: str = 'netcdf') -> None:
  """Writes the corpus under `out_dir` in `layout` ('netcdf' or 'npz')."""
  if layout not in LAYOUTS:
    raise ValueError(f'layout {layout!r}: one of {LAYOUTS}')
  os.makedirs(out_dir, exist_ok=True)
  levels = np.asarray(levels, np.int32)
  fields = synthesize_fields(resolution_deg, months, steps_per_month, levels,
                             seed, step_seconds)
  if layout == 'netcdf':
    _write_netcdf(out_dir, f'{resolution_deg:.2f}deg', levels, seed, fields)
  else:
    _write_npz(out_dir, levels, fields)


def synthesize_stats(out_dir: str,
                     levels: Sequence[int] = (
                         PRESSURE_LEVELS_WEATHERBENCH_13),
                     seed: int = 0,
                     prefix: str = 'gencast_stats_') -> None:
  """Writes DeepMind-layout normalization-stats NetCDF files (h5py).

  Produces {prefix}{mean,stddev,diffs_stddev}_by_level.nc in the exact
  structure shipped with the published GenCast weights (what the reference
  loads at training/train_helpers.py:190-211): atmospheric variables as
  [level] vectors on a `level` coordinate, surface/forcing variables as
  0-d scalars. `sources.load_stats_netcdf` is the consumer.
  """
  from gencast_tpu_torch.data import netcdf_writer

  os.makedirs(out_dir, exist_ok=True)
  rng = np.random.default_rng(seed)
  levels = np.asarray(levels, np.int32)
  surface_vars = set(registry.GENCAST_TARGET_SURFACE_VARS
                     + registry.FORCING_VARS + registry.STATIC_VARS)
  atmos_vars = registry.TARGET_ATMOSPHERIC_VARS

  def table(lo, hi):
    variables = {}
    for name in atmos_vars:
      variables[name] = (('level',), rng.uniform(
          lo, hi, levels.size).astype(np.float32))
    for name in sorted(surface_vars):
      variables[name] = ((), np.float32(rng.uniform(lo, hi)))
    return variables

  for kind, (lo, hi) in (('mean', (-1.0, 1.0)), ('stddev', (0.5, 3.0)),
                         ('diffs_stddev', (0.1, 1.0))):
    netcdf_writer.write_dataset(
        os.path.join(out_dir, f'{prefix}{kind}_by_level.nc'),
        {'level': levels.astype(np.float64)},
        table(lo, hi),
        global_attrs={'source': 'tools/synth_era5.py synthesize_stats',
                      'seed': seed})
  print(f'[synth_era5] wrote {prefix}*_by_level.nc stats to {out_dir}')


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--out', required=True)
  p.add_argument('--resolution', type=float, default=10.0)
  p.add_argument('--months', nargs='+', default=['202001'])
  p.add_argument('--steps_per_month', type=int, default=40)
  p.add_argument('--num_levels', type=int, default=13)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--layout', default='netcdf', choices=LAYOUTS,
                 help='netcdf: the CDS files (h5py); npz: the '
                      'Era5NpzSource shards tools.convert_era5 makes of '
                      'them (numpy only)')
  p.add_argument('--stats', action='store_true',
                 help='also write synthetic published-format stats files '
                      '(h5py)')
  args = p.parse_args(argv)
  levels = PRESSURE_LEVELS_WEATHERBENCH_13[-args.num_levels:]
  synthesize(args.out, args.resolution, args.months, args.steps_per_month,
             levels=levels, seed=args.seed, layout=args.layout)
  if args.stats:
    synthesize_stats(args.out, levels=levels, seed=args.seed)


if __name__ == '__main__':
  main()
