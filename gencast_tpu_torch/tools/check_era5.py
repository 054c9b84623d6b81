"""ERA5 NetCDF structure validator.

Counterpart of `tools/check_era5.py`, with the same checks, report and
exit codes. Validates a directory of CDS-downloaded ERA5 monthly files
against every expectation of the port's h5py reader
(gencast_tpu_torch/data/era5_netcdf.py) and exits non-zero on violations —
the role of the reference's training/check_era5_structure.py (non-zero
exit on schema problems), built for this reader instead of xarray's. It
needs h5py (the card's machine has none: check the files where they are
downloaded, then convert them with tools.convert_era5).

Checks per month pair (+ the static file):
  * file naming / pairing (pressure + single levels present per month)
  * coords: lat/lon/time present & decodable, lat strictly monotone,
    uniform spacing matching --resolution, lon covering the globe
  * time: decodable units, strictly increasing, uniform 12h steps
  * pressure file: level coord present; every requested --levels value
    present; required variables with (time, level, lat, lon) dims
  * single file: required variables with (time, lat, lon) dims
  * packing attrs (scale_factor/add_offset/_FillValue) finite
  * decoded data: finite (NaNs allowed only for sea_surface_temperature),
    grids consistent across files
  * static file: land_sea_mask + geopotential_at_surface

Usage:
  python -m gencast_tpu_torch.tools.check_era5 /path/to/era5 \
      --resolution 2.5 --levels 500 700 850
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from gencast_tpu_torch.data import era5_netcdf as nc

REQUIRED_PRESSURE = ('t', 'z', 'u', 'v', 'w', 'q')
REQUIRED_SINGLE_ANY = (
    ('t2m', '2t'), ('msl',), ('u10', '10u'), ('v10', '10v'), ('tp',))
NAN_OK_VARS = {'sea_surface_temperature'}


def _variables(f: 'nc._NcFile', var_map):
  """{standardized name: (h5 dataset, standardized dims)} of the data
  variables of `f` that `var_map` knows (by their ERA5 short name or
  already by their standardized name)."""
  out = {}
  for raw in f.f.keys():
    std = var_map.get(raw, raw if raw in var_map.values() else None)
    if std is None:
      continue
    dims = nc._dim_names(f.f[raw])
    if 'lat' in dims and 'lon' in dims:
      out[std] = (f.f[raw], dims)
  return out


class Report:
  def __init__(self, strict: bool = False):
    self.strict = strict
    self.errors = []
    self.warnings = []

  def error(self, msg):
    self.errors.append(msg)
    print(f'ERROR: {msg}')

  def warn(self, msg):
    self.warnings.append(msg)
    print(f'warning: {msg}')

  def missing(self, msg):
    """Missing-variable findings: errors under --strict (full GenCast
    variable set required), warnings otherwise (the reader accepts any
    subset covering the task)."""
    (self.error if self.strict else self.warn)(msg)


def _check_coords(f: 'nc._NcFile', path: str, spacing: float,
                  rep: Report):
  lat, lon = f.coord('lat'), f.coord('lon')
  base = os.path.basename(path)
  if lat is None or lon is None:
    rep.error(f'{base}: missing lat/lon coordinate')
    return None, None
  for name, c in (('lat', lat), ('lon', lon)):
    d = np.diff(c)
    if not (np.all(d > 0) or np.all(d < 0)):
      rep.error(f'{base}: {name} not strictly monotone')
    elif not np.allclose(np.abs(d), spacing, atol=1e-4):
      rep.error(f'{base}: {name} spacing {np.abs(d).mean():.4f} != '
                f'expected {spacing}')
  if np.abs(lat).max() > 90.0 + 1e-6:
    rep.error(f'{base}: lat outside [-90, 90]')
  span = lon.max() - lon.min()
  if span < 360.0 - 2 * spacing - 1e-6:
    rep.error(f'{base}: lon does not cover the globe (span {span:.2f})')
  return lat, lon


def _check_time(f: 'nc._NcFile', path: str, rep: Report):
  t = f.coord('time')
  base = os.path.basename(path)
  if t is None:
    rep.error(f'{base}: missing time/valid_time coordinate')
    return None
  if t.size > 1:
    d = np.diff(t)
    if not np.all(d > 0):
      rep.error(f'{base}: time not strictly increasing')
    elif not np.allclose(d, 12 * 3600, atol=1):
      rep.error(f'{base}: time step {d.mean()/3600:.2f}h != 12h')
  lo = (np.datetime64('1930-01-01') - np.datetime64('1970-01-01')
        ) / np.timedelta64(1, 's')
  hi = (np.datetime64('2100-01-01') - np.datetime64('1970-01-01')
        ) / np.timedelta64(1, 's')
  if t.min() < float(lo) or t.max() > float(hi):
    rep.error(f'{base}: decoded timestamps outside 1930..2100 — '
              'time units attribute probably mis-parsed')
  return t


def _check_packing(dset, std_name: str, base: str, rep: Report):
  for attr in ('scale_factor', 'add_offset'):
    v = dset.attrs.get(attr)
    if v is not None and not np.all(np.isfinite(np.asarray(v, np.float64))):
      rep.error(f'{base}: {std_name} has non-finite {attr}')


def _check_data(x: np.ndarray, std_name: str, base: str, rep: Report):
  if std_name in NAN_OK_VARS:
    frac = float(np.isnan(x).mean())
    if frac > 0.9:
      rep.error(f'{base}: {std_name} is {frac:.0%} NaN')
    return
  n_bad = int((~np.isfinite(x)).sum())
  if n_bad:
    rep.error(f'{base}: {std_name} has {n_bad} non-finite values')


def check_month(pressure_path: str, single_path: str, spacing: float,
                levels, rep: Report):
  fp = nc._NcFile(pressure_path)
  base_p = os.path.basename(pressure_path)
  lat_p, lon_p = _check_coords(fp, pressure_path, spacing, rep)
  t_p = _check_time(fp, pressure_path, rep)
  flevels = fp.coord('level')
  if flevels is None:
    rep.error(f'{base_p}: missing level/pressure_level coordinate')
  elif levels:
    for l in levels:
      if not np.any(np.abs(flevels - l) < 0.5):
        rep.error(f'{base_p}: requested level {l} hPa not in file '
                  f'(has {sorted(int(v) for v in flevels)})')

  pvars = _variables(fp, nc.PRESSURE_VAR_MAP)
  found_raw = set()
  for raw in fp.f.keys():
    if raw in nc.PRESSURE_VAR_MAP:
      found_raw.add(raw)
  for raw in REQUIRED_PRESSURE:
    if raw not in found_raw:
      rep.missing(f'{base_p}: missing pressure variable "{raw}" '
                  f'({nc.PRESSURE_VAR_MAP[raw]})')
  for std, (dset, dims) in pvars.items():
    want = {'time', 'level', 'lat', 'lon'}
    if set(dims) != want:
      rep.error(f'{base_p}: {std} dims {dims} != {sorted(want)}')
      continue
    _check_packing(dset, std, base_p, rep)
    x, _ = nc._canonicalize(nc._decode_var(dset), dims, lat_p,
                            want_level=True)
    if t_p is not None and x.shape[0] != t_p.size:
      rep.error(f'{base_p}: {std} time dim {x.shape[0]} != {t_p.size}')
    _check_data(x, std, base_p, rep)
  fp.close()

  fs = nc._NcFile(single_path)
  base_s = os.path.basename(single_path)
  lat_s, lon_s = _check_coords(fs, single_path, spacing, rep)
  t_s = _check_time(fs, single_path, rep)
  if (lat_p is not None and lat_s is not None
      and (lat_p.size != lat_s.size or lon_p.size != lon_s.size)):
    rep.error(f'{base_s}: grid {lat_s.size}x{lon_s.size} != pressure file '
              f'{lat_p.size}x{lon_p.size}')
  if (t_p is not None and t_s is not None
      and not np.array_equal(t_p, t_s)):
    rep.error(f'{base_s}: timestamps differ from pressure file')

  svars = _variables(fs, nc.SINGLE_VAR_MAP)
  raw_keys = set(fs.f.keys())
  for group in REQUIRED_SINGLE_ANY:
    if not any(r in raw_keys for r in group):
      rep.missing(f'{base_s}: missing single-level variable '
                  f'(any of {group})')
  for std, (dset, dims) in svars.items():
    want = {'time', 'lat', 'lon'}
    if set(dims) != want:
      rep.error(f'{base_s}: {std} dims {dims} != {sorted(want)}')
      continue
    _check_packing(dset, std, base_s, rep)
    x, _ = nc._canonicalize(nc._decode_var(dset), dims, lat_s,
                            want_level=False)
    _check_data(x, std, base_s, rep)
  fs.close()


def check_static(path: str, spacing: float, rep: Report):
  base = os.path.basename(path)
  f = nc._NcFile(path)
  _check_coords(f, path, spacing, rep)
  svars = _variables(f, nc.STATIC_VAR_MAP)
  for std in ('land_sea_mask', 'geopotential_at_surface'):
    if std not in svars:
      rep.missing(f'{base}: missing static variable {std}')
  for std, (dset, dims) in svars.items():
    _check_packing(dset, std, base, rep)
  f.close()


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('root', help='directory of ERA5 monthly NetCDF files')
  p.add_argument('--resolution', type=float, default=2.5)
  p.add_argument('--levels', type=int, nargs='*', default=[])
  p.add_argument('--grid_spacing', type=float, default=None,
                 help='expected lat/lon spacing in degrees '
                      '(default: --resolution)')
  p.add_argument('--strict', action='store_true',
                 help='missing variables are errors, not warnings')
  args = p.parse_args(argv)

  spacing = (args.grid_spacing if args.grid_spacing is not None
             else args.resolution)
  rep = Report(strict=args.strict)
  months = nc.find_month_files(args.root, args.resolution)
  if not months:
    rep.error(f'no month pairs era5_{{pressure,single}}_levels_*_'
              f'{args.resolution:.2f}deg.nc under {args.root}')
  for month, ppath, spath in months:
    print(f'checking month {month} ...')
    check_month(ppath, spath, spacing, args.levels, rep)

  static_path = os.path.join(args.root,
                             f'era5_static_{args.resolution:.2f}deg.nc')
  if os.path.exists(static_path):
    check_static(static_path, spacing, rep)
  else:
    rep.warn(f'no static file {os.path.basename(static_path)} '
             '(land_sea_mask / geopotential_at_surface unavailable)')

  print(f'\n{len(months)} month(s): {len(rep.errors)} error(s), '
        f'{len(rep.warnings)} warning(s)')
  return 1 if rep.errors else 0


if __name__ == '__main__':
  sys.exit(main())
