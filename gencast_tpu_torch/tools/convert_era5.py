"""Convert ERA5 monthly NetCDF files into gencast_tpu npz shards.

Counterpart of the repository's `tools/convert_era5.py`, file for file.
Reads CDS-download NetCDF (via h5py, no xarray needed) and writes the
`sources.Era5NpzSource` layout: era5_YYYYMM.npz shards + statics.npz +
manifest.json. The npz layout needs only numpy to read, so a directory
converted on a machine with h5py trains and evaluates on one without.
`write_month_shard` and `write_statics_and_manifest` are shared with
`tools.synth_era5 --layout npz`.

Usage:
  python -m gencast_tpu_torch.tools.convert_era5 --in /data/era5_nc \
      --out /data/era5_npz --resolution 2.5 --levels 13
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Mapping, Sequence

import numpy as np

from gencast_tpu_torch.data import era5_netcdf, registry


def write_month_shard(out_dir: str, month: str,
                      data: Mapping[str, np.ndarray],
                      times: np.ndarray) -> str:
  """Writes one month's standardized variables as era5_<month>.npz."""
  out_path = os.path.join(out_dir, f'era5_{month}.npz')
  np.savez_compressed(out_path, timestamps=times, **data)
  print(f'wrote {out_path}: {sorted(data)} T={len(times)}')
  return out_path


def write_statics_and_manifest(out_dir: str,
                               statics: Mapping[str, np.ndarray],
                               lat: np.ndarray, lon: np.ndarray,
                               levels: Sequence[int],
                               months: Sequence[str]) -> None:
  """Writes statics.npz and manifest.json (grid, levels, months)."""
  np.savez_compressed(os.path.join(out_dir, 'statics.npz'), **statics)
  with open(os.path.join(out_dir, 'manifest.json'), 'w') as f:
    json.dump({'lat': np.asarray(lat).tolist(),
               'lon': np.asarray(lon).tolist(),
               'pressure_levels': list(levels),
               'months': list(months)}, f)
  print(f'manifest + statics written to {out_dir}')


def convert(inp: str, out: str, resolution_deg: float = 2.5,
            num_levels: int = 13) -> None:
  """Converts every month of `inp` (and its static file, if any)."""
  levels = registry.PRESSURE_LEVELS[num_levels]
  months = era5_netcdf.find_month_files(inp, resolution_deg)
  if not months:
    raise SystemExit(f'no ERA5 monthly files found under {inp}')
  os.makedirs(out, exist_ok=True)

  lat = lon = None
  for ym, ppath, spath in months:
    data, times, lat, lon = era5_netcdf.read_month(ppath, spath,
                                                   levels=levels)
    write_month_shard(out, ym, data, times)

  res = f'{resolution_deg:.2f}deg'
  static_path = os.path.join(inp, f'era5_static_{res}.nc')
  statics = {}
  if os.path.exists(static_path):
    statics, _, _ = era5_netcdf.read_static(static_path)
  write_statics_and_manifest(out, statics, lat, lon, levels,
                             [m for m, _, _ in months])


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--in', dest='inp', required=True)
  p.add_argument('--out', required=True)
  p.add_argument('--resolution', type=float, default=2.5)
  p.add_argument('--levels', type=int, default=13, choices=[13, 25, 37])
  args = p.parse_args(argv)
  convert(args.inp, args.out, args.resolution, args.levels)


if __name__ == '__main__':
  main()
