"""Minimal NetCDF4 writer on h5py — no netCDF4/xarray dependency.

Counterpart of `gencast_tpu.data.netcdf_writer`: the same files from the
same arrays. h5py is imported inside the writer, never at import (the
card's machine has none; evaluate's --save_netcdf then prints and skips,
as the reference's does).

NetCDF4 files are HDF5 files whose dimensions are HDF5 dimension scales;
this module writes that convention directly (coordinate variables are
both a dimension scale and data, data variables attach the scales), so
the output opens with netCDF4-python, xarray (netcdf4/h5netcdf engines),
ncdump, and this package's own h5py reader (data/era5_netcdf.py).

Role of the reference's compressed rollout export
(training/evaluation.py:194-260: xarray.Dataset.to_netcdf with per-
variable zlib encoding); here the deliverable artifact is produced
without requiring the xarray stack.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data import registry


def write_dataset(path: str,
                  dims: Mapping[str, np.ndarray],
                  variables: Mapping[str, Tuple[Sequence[str], np.ndarray]],
                  global_attrs: Optional[Mapping[str, object]] = None,
                  compression_level: int = 4,
                  dim_attrs: Optional[Mapping[str, Mapping]] = None) -> None:
  """Writes a NetCDF4 (HDF5 + dimension scales) file.

  Args:
    path: output .nc path.
    dims: name -> 1-D coordinate values (become coordinate variables).
    variables: name -> (dim names, array); array shape must match the
      dims' lengths.
    global_attrs: file-level attributes.
    compression_level: gzip level for data variables (the reference's
      default zlib complevel is 4); 0 disables.
  """
  import h5py

  with h5py.File(path, 'w') as f:
    scales = {}
    for name, values in dims.items():
      values = np.asarray(values)
      d = f.create_dataset(name, data=values)
      d.make_scale(name)
      # netCDF4-python looks for _Netcdf4Dimid to order dimensions; it
      # falls back gracefully, but writing it keeps ncdump output tidy.
      d.attrs['_Netcdf4Dimid'] = np.int32(len(scales))
      for k, val in (dim_attrs or {}).get(name, {}).items():
        d.attrs[k] = val
      scales[name] = d

    for name, (var_dims, data) in variables.items():
      data = np.asarray(data)
      if data.ndim != len(var_dims):
        raise ValueError(f'{name}: {data.ndim}-d data with dims {var_dims}')
      for ax, dim in enumerate(var_dims):
        if dim not in scales:
          raise ValueError(f'{name}: unknown dim {dim!r}')
        if data.shape[ax] != scales[dim].shape[0]:
          raise ValueError(
              f'{name}: axis {ax} has size {data.shape[ax]}, dim {dim!r} '
              f'has length {scales[dim].shape[0]}')
      kw = {}
      if compression_level and data.size > 1:
        kw = dict(compression='gzip', compression_opts=compression_level,
                  shuffle=True, chunks=True)
      v = f.create_dataset(name, data=data, **kw)
      for ax, dim in enumerate(var_dims):
        v.dims[ax].attach_scale(scales[dim])

    for k, val in (global_attrs or {}).items():
      f.attrs[k] = val


def _unpack_steps(fields: np.ndarray, layout: layout_lib.ChannelLayout
                  ) -> Dict[str, np.ndarray]:
  """[K, lat, lon, C] (single-frame layout) -> var -> [K, (L,) lat, lon]."""
  assert layout.num_times == 1, layout.num_times
  out = {}
  for name, x in layout_lib.unpack(fields, layout).items():
    x = np.asarray(x)
    if registry.is_static(name):
      out[name] = x[0]  # constant across steps
    else:
      out[name] = x[:, 0]  # squeeze the single time frame
  return out


def write_forecast(path: str,
                   preds: np.ndarray,       # [K, lat, lon, C]
                   layout: layout_lib.ChannelLayout,
                   lat: np.ndarray, lon: np.ndarray,
                   truth: Optional[np.ndarray] = None,  # [K, lat, lon, C]
                   lead_hours: float = 12.0,
                   global_attrs: Optional[Mapping[str, object]] = None,
                   compression_level: int = 4) -> None:
  """Writes a K-step forecast (and optional matching targets) to NetCDF.

  Variables are unpacked from the channel layout into reference-
  convention datasets: surface (time, lat, lon), atmospheric
  (time, level, lat, lon), static (lat, lon); targets are written as
  `target_<name>` alongside predictions, matching the reference's merged
  export (training/evaluation.py:226-243).
  """
  preds = np.asarray(preds)
  k = preds.shape[0]
  dims = {
      'time': np.arange(1, k + 1, dtype=np.float64) * lead_hours * 3600.0,
      'lat': np.asarray(lat, np.float64),
      'lon': np.asarray(lon, np.float64),
  }
  if layout.pressure_levels:
    dims['level'] = np.asarray(layout.pressure_levels, np.int32)

  def var_entry(name, x):
    if registry.is_static(name):
      return (('lat', 'lon'), x)
    if registry.is_atmospheric(name):
      return (('time', 'level', 'lat', 'lon'), x)
    return (('time', 'lat', 'lon'), x)

  variables = {}
  for name, x in _unpack_steps(preds, layout).items():
    variables[name] = var_entry(name, x)
  if truth is not None:
    for name, x in _unpack_steps(np.asarray(truth), layout).items():
      variables[f'target_{name}'] = var_entry(name, x)

  attrs = {'description': 'gencast_tpu autoregressive rollout',
           'lead_hours': float(lead_hours)}
  attrs.update(global_attrs or {})
  write_dataset(path, dims, variables, attrs,
                compression_level=compression_level,
                dim_attrs={'time': {'units': 'seconds since forecast start'},
                           'lat': {'units': 'degrees_north'},
                           'lon': {'units': 'degrees_east'},
                           **({'level': {'units': 'hPa'}}
                              if layout.pressure_levels else {})})
