"""Optional xarray boundary adapter.

Counterpart of `gencast_tpu.data.xarray_bridge`. The framework's device
data model is packed arrays; this module converts between `xarray.Dataset` objects (the reference's data model and the common
interchange format for weather data) and packed tensors at the HOST
boundary only. Requires xarray to be installed — it is an optional
dependency, imported lazily; nothing else in gencast_tpu_torch depends on
it.

Packing order matches `data/layout.py` (sorted variable names, time-major /
level-minor), which in turn matches the reference's `dataset_to_stacked`
(common/model_utils.py:594-659), so datasets prepared for the reference
pipeline convert losslessly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data import registry


def _require_xarray():
  try:
    import xarray
  except ImportError as e:
    raise ImportError(
        'gencast_tpu_torch.data.xarray_bridge requires xarray; install it '
        'or use the packed-array APIs (gencast_tpu_torch.data.layout) '
        'directly.') from e
  return xarray


def dataset_to_packed(dataset, layout: layout_lib.ChannelLayout
                      ) -> np.ndarray:
  """xarray.Dataset -> [batch, lat, lon, C] numpy array.

  Expects reference-convention dims: surface (batch, time, lat, lon),
  atmospheric (batch, time, level, lat, lon), static (lat, lon); a missing
  batch dim is added.
  """
  _require_xarray()
  parts = []
  batch = None
  for name in layout.var_names:
    da = dataset[name]
    dims = da.dims
    x = np.asarray(da.data)
    if 'batch' not in dims and not registry.is_static(name):
      x = x[None]
      dims = ('batch',) + dims
    if registry.is_static(name):
      parts.append(('static', name, x))
      continue
    order = [d for d in ('batch', 'time', 'level', 'lat', 'lon')
             if d in dims]
    x = np.transpose(x, [dims.index(d) for d in order])
    batch = x.shape[0]
    t = x.shape[1]
    if 'level' in order:
      l = x.shape[2]
      x = np.moveaxis(x.reshape(batch, t * l, x.shape[3], x.shape[4]), 1, 3)
    else:
      x = np.moveaxis(x, 1, 3)
    parts.append(('data', name, x))
  if batch is None:
    batch = 1
  out = []
  for kind, name, x in parts:
    if kind == 'static':
      out.append(np.broadcast_to(x[None, :, :, None],
                                 (batch,) + x.shape + (1,)))
    else:
      out.append(x)
  return np.concatenate(out, axis=-1).astype(np.float32)


def packed_to_dataset(packed: np.ndarray, layout: layout_lib.ChannelLayout,
                      lat: np.ndarray, lon: np.ndarray,
                      times: Optional[np.ndarray] = None):
  """[batch, lat, lon, C] -> xarray.Dataset with reference-convention dims."""
  xarray = _require_xarray()
  packed = np.asarray(packed)
  b = packed.shape[0]
  nl = len(layout.pressure_levels)
  coords = {'lat': np.asarray(lat), 'lon': np.asarray(lon),
            'level': np.asarray(layout.pressure_levels)}
  if times is not None:
    coords['time'] = np.asarray(times)
  data_vars = {}
  idx = 0
  for name in layout.var_names:
    if registry.is_static(name):
      data_vars[name] = (('lat', 'lon'), packed[0, :, :, idx])
      idx += 1
      continue
    t = layout.num_times
    if registry.is_atmospheric(name):
      c = t * nl
      x = packed[..., idx:idx + c]
      x = np.moveaxis(x.reshape(b, x.shape[1], x.shape[2], t, nl),
                      (3, 4), (1, 2))
      data_vars[name] = (('batch', 'time', 'level', 'lat', 'lon'), x)
      idx += c
    else:
      x = np.moveaxis(packed[..., idx:idx + t], 3, 1)
      data_vars[name] = (('batch', 'time', 'lat', 'lon'), x)
      idx += t
  return xarray.Dataset(data_vars, coords=coords)
