"""ERA5 NetCDF4 reading via h5py — no xarray/netCDF4 dependency.

Counterpart of `gencast_tpu.data.era5_netcdf`, array for array. NetCDF4
files are HDF5 underneath; this module reads the ERA5 monthly files
produced by CDS downloads (the reference's layout,
training/era5_dataset.py:43-345):

  era5_pressure_levels_YYYYMM_<res>deg.nc
  era5_single_levels_YYYYMM_<res>deg.nc
  era5_static_<res>deg.nc

applying the same standardization: dim renames (valid_time -> time,
pressure_level -> level, latitude/longitude -> lat/lon), ERA5 short-name ->
GraphCast-name variable mapping, packed-data decoding
(scale_factor/add_offset/_FillValue), ascending-latitude reordering, and
12-hour precipitation accumulation by time differencing.

h5py is imported where a file is opened, never at import: the card's
machine has no h5py and reads the npz layout (`sources.Era5NpzSource`).
The standardization itself works on in-memory arrays too
(`standardize_month`, `standardize_static`), so the synthesizer's npz
layout gives exactly what this reader gives for the NetCDF files.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from gencast_tpu_torch.data import forcings as forcings_lib
from gencast_tpu_torch.data import registry, sources

DIM_RENAMES = {
    'valid_time': 'time', 'pressure_level': 'level',
    'latitude': 'lat', 'longitude': 'lon',
}

PRESSURE_VAR_MAP = {
    't': 'temperature', 'z': 'geopotential',
    'u': 'u_component_of_wind', 'v': 'v_component_of_wind',
    'w': 'vertical_velocity', 'q': 'specific_humidity',
}

SINGLE_VAR_MAP = {
    't2m': '2m_temperature', '2t': '2m_temperature',
    'msl': 'mean_sea_level_pressure',
    'u10': '10m_u_component_of_wind', '10u': '10m_u_component_of_wind',
    'v10': '10m_v_component_of_wind', '10v': '10m_v_component_of_wind',
    'sst': 'sea_surface_temperature',
    'tp': 'total_precipitation',
    'tisr': 'toa_incident_solar_radiation',
}

STATIC_VAR_MAP = {
    'lsm': 'land_sea_mask', 'z': 'geopotential_at_surface',
}

_EPOCH_UNITS = re.compile(
    r'(seconds|hours|days)\s+since\s+(\d{4}-\d{2}-\d{2})[T ]?'
    r'(\d{2}:\d{2}(:\d{2}(\.\d+)?)?)?')
_UNIT_SECONDS = {'seconds': 1.0, 'hours': 3600.0, 'days': 86400.0}

# {raw name: (standardized dim names, decoded array)}, in file order.
RawVariables = Mapping[str, Tuple[Sequence[str], np.ndarray]]


def decode(data: np.ndarray, fill=None, scale=None, offset=None
           ) -> np.ndarray:
  """Applies the NetCDF packing conventions to raw stored values: values
  equal to `fill` become NaN, then value * scale + offset in float64,
  returned as float32; float data without attributes as float32."""
  if scale is not None or offset is not None or fill is not None:
    out = data.astype(np.float64)
    if fill is not None:
      out = np.where(data == np.asarray(fill), np.nan, out)
    if scale is not None:
      out = out * np.asarray(scale, np.float64)
    if offset is not None:
      out = out + np.asarray(offset, np.float64)
    return out.astype(np.float32)
  return data.astype(np.float32) if data.dtype.kind == 'f' else data


def _decode_var(dset) -> np.ndarray:
  """Reads an HDF5 dataset applying NetCDF packing conventions."""
  attrs = dset.attrs
  return decode(dset[...], attrs.get('_FillValue', attrs.get('missing_value')),
                attrs.get('scale_factor'), attrs.get('add_offset'))


def time_seconds(vals: np.ndarray, units) -> np.ndarray:
  """Time coordinate values in `units` -> float64 seconds since the Unix
  epoch."""
  if isinstance(units, bytes):
    units = units.decode()
  vals = np.asarray(vals).astype(np.float64)
  m = _EPOCH_UNITS.match(units.strip()) if units else None
  if m is None:
    # ERA5 'valid_time' default is seconds since 1970-01-01.
    return vals
  unit_s = _UNIT_SECONDS[m.group(1)]
  base = np.datetime64(m.group(2) + ('T' + m.group(3) if m.group(3)
                                     else 'T00:00:00'))
  base_s = (base - np.datetime64('1970-01-01T00:00:00')
            ) / np.timedelta64(1, 's')
  return vals * unit_s + float(base_s)


def _decode_time(dset) -> np.ndarray:
  """Time coordinate -> float64 seconds since the Unix epoch."""
  return time_seconds(dset[...], dset.attrs.get('units', b''))


def _dim_names(h5var) -> List[str]:
  """NetCDF dimension names of an HDF5 variable, standardized."""
  names = []
  dimlist = h5var.attrs.get('DIMENSION_LIST')
  if dimlist is not None:
    for refs in dimlist:
      ref = refs[0]
      name = h5var.file[ref].name.lstrip('/').split('/')[-1]
      names.append(DIM_RENAMES.get(name, name))
  return names


class _NcFile:
  """Minimal standardized view of one ERA5 NetCDF file."""

  def __init__(self, path: str):
    import h5py
    self.f = h5py.File(path, 'r')

  def close(self):
    self.f.close()

  def coord(self, name: str) -> Optional[np.ndarray]:
    for raw, std in [(k, DIM_RENAMES.get(k, k)) for k in self.f.keys()]:
      if std == name and raw in self.f:
        if name == 'time':
          return _decode_time(self.f[raw])
        return np.asarray(self.f[raw][...], np.float64)
    return None

  def raw_variables(self) -> Dict[str, Tuple[List[str], np.ndarray]]:
    """{raw name: (standardized dims, decoded array)} of every variable on
    the lat/lon grid, in file order."""
    out = {}
    for raw in self.f.keys():
      dims = _dim_names(self.f[raw])
      if 'lat' in dims and 'lon' in dims:
        out[raw] = (dims, _decode_var(self.f[raw]))
    return out


def _mapped(raw_vars: RawVariables, var_map: Mapping[str, str]):
  """(standardized name, dims, array) of the variables `var_map` knows (by
  their ERA5 short name or already by their standardized name)."""
  for raw, (dims, data) in raw_vars.items():
    std = var_map.get(raw, raw if raw in var_map.values() else None)
    if std is not None:
      yield std, dims, data


def _canonicalize(data: np.ndarray, dims: Sequence[str], lat: np.ndarray,
                  want_level: bool) -> Tuple[np.ndarray, np.ndarray]:
  """Reorders to [time, (level,) lat, lon] and flips latitude ascending."""
  order = [d for d in (['time', 'level', 'lat', 'lon'] if want_level
                       else ['time', 'lat', 'lon']) if d in dims]
  perm = [dims.index(d) for d in order]
  x = np.transpose(data, perm)
  while x.ndim < (4 if want_level else 3):
    x = x[None]
  if lat[0] > lat[-1]:  # descending -> flip
    x = np.flip(x, axis=-2)
  return x, np.sort(lat)


def precipitation_12hr(tp: np.ndarray) -> np.ndarray:
  """Cumulative precipitation [T, ...] -> its 12-hour accumulation by
  differencing (reference era5_dataset.py:297-323); first step zero."""
  diff = np.concatenate([np.zeros_like(tp[:1]), np.diff(tp, axis=0)])
  return np.maximum(diff, 0.0)


def standardize_month(pressure_vars: RawVariables, single_vars: RawVariables,
                      lat: np.ndarray, file_levels: Optional[np.ndarray],
                      levels: Optional[Tuple[int, ...]] = None
                      ) -> Dict[str, np.ndarray]:
  """One month's decoded variables -> {GraphCast name: [T, (L,) lat, lon]}
  with latitude ascending, the `levels` selected from `file_levels` and the
  cumulative precipitation differenced to 12 hours."""
  out: Dict[str, np.ndarray] = {}
  lvl_sel = None
  if levels is not None and file_levels is not None:
    lvl_sel = np.asarray([int(np.argmin(np.abs(file_levels - l)))
                          for l in levels])
  for name, dims, data in _mapped(pressure_vars, PRESSURE_VAR_MAP):
    x, _ = _canonicalize(data, dims, lat, want_level=True)
    if lvl_sel is not None:
      # File levels may be in any order; select requested ones.
      x = x[:, lvl_sel]
    out[name] = x
  for name, dims, data in _mapped(single_vars, SINGLE_VAR_MAP):
    x, _ = _canonicalize(data, dims, lat, want_level=False)
    out[name] = x
  if 'total_precipitation' in out:
    out['total_precipitation_12hr'] = precipitation_12hr(
        out.pop('total_precipitation'))
  return out


def standardize_static(raw_vars: RawVariables, lat: np.ndarray
                       ) -> Dict[str, np.ndarray]:
  """The static file's decoded variables -> {GraphCast name: [lat, lon]},
  latitude ascending."""
  out = {}
  for name, dims, data in _mapped(raw_vars, STATIC_VAR_MAP):
    x, _ = _canonicalize(data, dims, lat, want_level=False)
    out[name] = x[0] if x.ndim == 3 else x  # drop singleton time
  return out


def read_month(pressure_path: str, single_path: str,
               levels: Optional[Tuple[int, ...]] = None
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                          np.ndarray, np.ndarray]:
  """Reads one month: ({var: array}, timestamps, lat, lon)."""
  fp = _NcFile(pressure_path)
  try:
    lat = fp.coord('lat')
    lon = fp.coord('lon')
    times = fp.coord('time')
    flevels = fp.coord('level')
    pressure_vars = fp.raw_variables()
  finally:
    fp.close()
  fs = _NcFile(single_path)
  try:
    single_vars = fs.raw_variables()
  finally:
    fs.close()
  out = standardize_month(pressure_vars, single_vars, lat, flevels, levels)
  return out, times, np.sort(lat), lon


def read_static(path: str) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                    np.ndarray]:
  fs = _NcFile(path)
  try:
    lat = fs.coord('lat')
    lon = fs.coord('lon')
    raw_vars = fs.raw_variables()
  finally:
    fs.close()
  return standardize_static(raw_vars, lat), np.sort(lat), lon


def find_month_files(root: str, resolution_deg: float = 2.5
                     ) -> List[Tuple[str, str, str]]:
  """[(YYYYMM, pressure_path, single_path)] matching the reference naming."""
  res = f'{resolution_deg:.2f}deg'
  def month_id(p):
    return os.path.basename(p).split('_')[-2]
  pressure = {month_id(p): p for p in
              sorted(glob.glob(os.path.join(
                  root, f'era5_pressure_levels_*_{res}.nc')))}
  single = {month_id(p): p for p in
            sorted(glob.glob(os.path.join(
                root, f'era5_single_levels_*_{res}.nc')))}
  months = sorted(set(pressure) & set(single))
  return [(m, pressure[m], single[m]) for m in months]


class Era5NetCDFSource(sources.WindowedSource):
  """Training source reading ERA5 monthly NetCDF files directly (h5py)."""

  def __init__(self, root: str, task: registry.TaskSpec,
               resolution_deg: float = 2.5,
               step_seconds: float = 12 * 3600):
    months = find_month_files(root, resolution_deg)
    if not months:
      raise FileNotFoundError(f'no ERA5 monthly files under {root}')
    data: Dict[str, List[np.ndarray]] = {}
    times = []
    lat = lon = None
    for _, ppath, spath in months:
      month_data, t, lat, lon = read_month(ppath, spath,
                                           levels=task.pressure_levels)
      times.append(t)
      for k, v in month_data.items():
        data.setdefault(k, []).append(v)
    self._times = np.concatenate(times)
    order = np.argsort(self._times)
    self._times = self._times[order]
    self._data = {k: np.concatenate(v, axis=0)[order]
                  for k, v in data.items()}

    res = f'{resolution_deg:.2f}deg'
    static_path = os.path.join(root, f'era5_static_{res}.nc')
    self._statics = {}
    if os.path.exists(static_path):
      self._statics, _, _ = read_static(static_path)

    super().__init__(task, lat, lon, step_seconds)

  def timestamps(self) -> np.ndarray:
    return self._times

  def field(self, name: str, times: np.ndarray) -> np.ndarray:
    if registry.is_static(name):
      return self._statics[name]
    if name in registry.FORCING_VARS and name not in self._data:
      return forcings_lib.all_forcings(times, self.lat, self.lon, (name,),
                                       device=self.forcing_device)[name]
    idx = np.searchsorted(self._times, times)
    return self._data[name][idx]
