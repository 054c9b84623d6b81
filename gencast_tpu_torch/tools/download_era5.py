"""ERA5 download CLI (CDS, the Copernicus Climate Data Store), over the
port's registry.

Counterpart of the root `tools/download_era5.py`, which imports the JAX
package's registry: this one runs where only the port is installed. It
fetches the variables a `gencast_tpu_torch.data.registry.TaskSpec` needs,
in monthly NetCDF files named as `data.era5_netcdf` discovers them:

  era5_pressure_levels_YYYYMM_<res>deg.nc
  era5_single_levels_YYYYMM_<res>deg.nc
  era5_static_<res>deg.nc

The variable lists come from the registry: the task's surface and
atmospheric split plus the TISR forcing, with the derived names mapped back
to CDS naming (total_precipitation_12hr -> total_precipitation, summed at
read time).

`--dry_run` prints the CDS requests as JSON lines without contacting the
network. The download itself needs the `cdsapi` package and ~/.cdsapirc
credentials; the package is imported only on that path.

  python -m gencast_tpu_torch.tools.download_era5 --out_dir D \
      --start 2019-01 --end 2019-12 --resolution 1.0 --dry_run
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gencast_tpu_torch.data import registry

# The registry's derived names -> CDS request names.
_CDS_NAME = {
    'total_precipitation_12hr': 'total_precipitation',
    'total_precipitation_6hr': 'total_precipitation',
    'geopotential_at_surface': 'geopotential',
}

_SINGLE_LEVEL_DATASET = 'reanalysis-era5-single-levels'
_PRESSURE_LEVEL_DATASET = 'reanalysis-era5-pressure-levels'


def _cds_names(names) -> list:
  out = []
  for n in names:
    n = _CDS_NAME.get(n, n)
    if n not in out:
      out.append(n)
  return out


def split_task_variables(task: registry.TaskSpec):
  """(single_level, pressure_level, static) CDS variable lists for a task.

  Atmospheric variables are the ones defined on pressure levels
  (registry.TARGET_ATMOSPHERIC_VARS); generated forcings are computed
  from timestamps, not downloaded."""
  atmos, single = [], []
  wanted = set(task.input_variables) | set(task.target_variables) | \
      set(task.forcing_variables)
  for v in sorted(wanted):
    if v in registry.GENERATED_FORCING_VARS or v in registry.STATIC_VARS:
      continue
    (atmos if v in registry.TARGET_ATMOSPHERIC_VARS else single).append(v)
  # Statics are always fetched: every task embeds them even when they are
  # not listed as inputs (the converter injects them per frame).
  return (_cds_names(single), _cds_names(atmos),
          _cds_names(registry.STATIC_VARS))


def month_range(start: str, end: str):
  """'YYYY-MM' inclusive range -> [(year, month), ...]."""
  y0, m0 = (int(p) for p in start.split('-'))
  y1, m1 = (int(p) for p in end.split('-'))
  out = []
  y, m = y0, m0
  while (y, m) <= (y1, m1):
    out.append((y, m))
    m += 1
    if m == 13:
      y, m = y + 1, 1
  return out


def build_requests(task: registry.TaskSpec, year: int, month: int,
                   resolution: float, hours) -> dict:
  """{dataset_kind: cds_request} for one month of one task."""
  single, atmos, _ = split_task_variables(task)
  base = {
      'product_type': 'reanalysis',
      'year': str(year),
      'month': f'{month:02d}',
      'day': [f'{d:02d}' for d in range(1, 32)],
      'time': [f'{h:02d}:00' for h in hours],
      'grid': f'{resolution}/{resolution}',
      'format': 'netcdf',
  }
  return {
      'single_levels': dict(base, variable=single),
      'pressure_levels': dict(
          base, variable=atmos,
          pressure_level=[str(p) for p in task.pressure_levels]),
  }


def build_static_request(task: registry.TaskSpec, resolution: float) -> dict:
  _, _, static = split_task_variables(task)
  return {
      'product_type': 'reanalysis',
      'variable': static,
      'year': '2019', 'month': '01', 'day': '01', 'time': '00:00',
      'grid': f'{resolution}/{resolution}',
      'format': 'netcdf',
  }


def _client():
  try:
    import cdsapi  # type: ignore
  except ImportError:
    sys.exit('download_era5: the `cdsapi` package is not installed. '
             'Install it and configure ~/.cdsapirc, or fetch the files '
             'elsewhere and point --data at the directory; '
             'gencast_tpu_torch.tools.check_era5 validates a download.')
  return cdsapi.Client()


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--out_dir', required=True)
  p.add_argument('--start', required=True, help='YYYY-MM (inclusive)')
  p.add_argument('--end', required=True, help='YYYY-MM (inclusive)')
  p.add_argument('--resolution', type=float, default=1.0)
  p.add_argument('--task', default='gencast_full',
                 choices=sorted(registry.TASKS))
  p.add_argument('--hours', type=int, nargs='*', default=[0, 12],
                 help='UTC analysis hours (GenCast cadence: 00/12)')
  p.add_argument('--dry_run', action='store_true',
                 help='print the CDS requests as JSON and exit')
  args = p.parse_args(argv)

  task = registry.TASKS[args.task]
  months = month_range(args.start, args.end)
  res = f'{args.resolution:.2f}deg'

  plans = [('static', _SINGLE_LEVEL_DATASET,
            build_static_request(task, args.resolution),
            os.path.join(args.out_dir, f'era5_static_{res}.nc'))]
  for y, m in months:
    reqs = build_requests(task, y, m, args.resolution, args.hours)
    for kind, dataset in (('single_levels', _SINGLE_LEVEL_DATASET),
                          ('pressure_levels', _PRESSURE_LEVEL_DATASET)):
      plans.append((kind, dataset, reqs[kind], os.path.join(
          args.out_dir, f'era5_{kind}_{y}{m:02d}_{res}.nc')))

  if args.dry_run:
    for kind, dataset, req, path in plans:
      print(json.dumps({'kind': kind, 'dataset': dataset, 'target': path,
                        'request': req}))
    return

  os.makedirs(args.out_dir, exist_ok=True)
  client = _client()
  for kind, dataset, req, path in plans:
    if os.path.exists(path):
      print(f'[download] {path} exists, skipping')
      continue
    print(f'[download] {dataset} -> {path}')
    client.retrieve(dataset, req, path)
  print(f'[download] done; validate with: python -m '
        f'gencast_tpu_torch.tools.check_era5 --data {args.out_dir} '
        f'--resolution {args.resolution}')


if __name__ == '__main__':
  main()
