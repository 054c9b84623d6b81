"""The port's ERA5 NetCDF reader and writer against the JAX package's.

A corpus written by the JAX package's `tools/synth_era5.py` (descending
latitude, int16-packed temperature, NaN SST over land, cumulative
precipitation, two months) is read by both packages' readers: months,
statics and the source's windows must be equal bit for bit (numpy code on
both sides). The port's synthesizer and writer, read back by the JAX
reader, must give the JAX corpus's arrays, and the port's `write_forecast`
the JAX writer's file, dataset for dataset.
"""

import os

import numpy as np
import pytest

h5py = pytest.importorskip('h5py')

from gencast_tpu.data import era5_netcdf as jax_nc  # noqa: E402
from gencast_tpu.data import layout as jax_layout  # noqa: E402
from gencast_tpu.data import netcdf_writer as jax_writer  # noqa: E402
from gencast_tpu_torch.data import era5_netcdf, layout, netcdf_writer, \
    registry  # noqa: E402
from gencast_tpu_torch.tools import synth_era5  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

MONTHS = ('202001', '202002')
STEPS = 6
RES = 10.0


@pytest.fixture(scope='module')
def jax_corpus(tmp_path_factory):
  from tools import synth_era5 as jax_synth
  root = str(tmp_path_factory.mktemp('jax_era5'))
  jax_synth.synthesize(root, resolution_deg=RES, months=MONTHS,
                       steps_per_month=STEPS, seed=3)
  return root


@pytest.fixture(scope='module')
def port_corpus(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('port_era5'))
  synth_era5.synthesize(root, resolution_deg=RES, months=MONTHS,
                        steps_per_month=STEPS, seed=3)
  return root


def _assert_tables_equal(got, want):
  assert list(got) == list(want)
  for name in want:
    assert got[name].dtype == want[name].dtype, name
    np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_month_files_are_found_by_resolution(jax_corpus):
  months = era5_netcdf.find_month_files(jax_corpus, RES)
  assert months == jax_nc.find_month_files(jax_corpus, RES)
  assert [m for m, _, _ in months] == list(MONTHS)
  # The files name their resolution: another one finds nothing.
  assert era5_netcdf.find_month_files(jax_corpus, 2.5) == []


@pytest.mark.parametrize('levels', [None, (50, 500, 1000)])
def test_read_month_equals_the_jax_reader(jax_corpus, levels):
  for _, ppath, spath in jax_nc.find_month_files(jax_corpus, RES):
    got, times, lat, lon = era5_netcdf.read_month(ppath, spath, levels)
    want, w_times, w_lat, w_lon = jax_nc.read_month(ppath, spath, levels)
    _assert_tables_equal(got, want)
    for a, b in ((times, w_times), (lat, w_lat), (lon, w_lon)):
      assert a.dtype == b.dtype
      np.testing.assert_array_equal(a, b)
    # The four deliberate pieces: latitude ascending, temperature decoded
    # from int16, SST NaN over land, precipitation differenced to 12 h.
    assert lat[0] < lat[-1]
    assert got['temperature'].dtype == np.float32
    assert np.isnan(got['sea_surface_temperature']).any()
    assert (got['total_precipitation_12hr'][0] == 0).all()
    assert 'total_precipitation' not in got


def test_read_static_equals_the_jax_reader(jax_corpus):
  path = os.path.join(jax_corpus, f'era5_static_{RES:.2f}deg.nc')
  got, lat, lon = era5_netcdf.read_static(path)
  want, w_lat, w_lon = jax_nc.read_static(path)
  _assert_tables_equal(got, want)
  np.testing.assert_array_equal(lat, w_lat)
  np.testing.assert_array_equal(lon, w_lon)
  assert got['land_sea_mask'].shape == (19, 36)


def test_decode_and_time_conventions_equal_the_jax_reader(tmp_path):
  """The packing conventions on their own: fill, scale and offset, and
  time units in hours since a date with a clock time."""
  data = np.array([[-32767, 0, 100], [7, -5, 32000]], np.int16)
  path = str(tmp_path / 'packed.h5')
  with h5py.File(path, 'w') as f:
    d = f.create_dataset('x', data=data)
    d.attrs['_FillValue'] = np.int16(-32767)
    d.attrs['scale_factor'] = np.float64(0.01)
    d.attrs['add_offset'] = np.float64(250.0)
    t = f.create_dataset('t', data=np.array([0.0, 12.0, 36.5]))
    t.attrs['units'] = np.bytes_(b'hours since 2020-01-01 06:00')
    with_unknown = f.create_dataset('u', data=np.array([5.0, 6.0]))
    with_unknown.attrs['units'] = np.bytes_(b'steps')
  with h5py.File(path, 'r') as f:
    for name, fn, jax_fn in (('x', era5_netcdf._decode_var,
                              jax_nc._decode_var),
                             ('t', era5_netcdf._decode_time,
                              jax_nc._decode_time),
                             ('u', era5_netcdf._decode_time,
                              jax_nc._decode_time)):
      got, want = fn(f[name]), jax_fn(f[name])
      assert got.dtype == want.dtype
      np.testing.assert_array_equal(got, want)
    assert np.isnan(era5_netcdf._decode_var(f['x'])[0, 0])


def test_source_windows_equal_the_jax_source(jax_corpus):
  from gencast_tpu.data import registry as jax_registry
  task = registry.GENCAST_TASK
  src = era5_netcdf.Era5NetCDFSource(jax_corpus, task, resolution_deg=RES)
  ref = jax_nc.Era5NetCDFSource(jax_corpus, jax_registry.GENCAST_TASK,
                                resolution_deg=RES)
  assert len(src) == len(ref) == len(MONTHS) * STEPS - 2
  np.testing.assert_array_equal(src.timestamps(), ref.timestamps())
  np.testing.assert_array_equal(src.lat, ref.lat)
  # The first window, one across the month boundary, and a 3-frame one.
  for index, frames in ((0, 1), (STEPS - 2, 1), (3, 3)):
    got, want = src.sample(index, frames), ref.sample(index, frames)
    for part in ('inputs', 'targets', 'forcings'):
      np.testing.assert_array_equal(getattr(got, part), getattr(want, part),
                                    err_msg=f'{index} {part}')
    assert got.timestamp == want.timestamp


def test_the_ports_corpus_reads_as_the_jax_corpus(jax_corpus, port_corpus):
  """The port's synthesizer and writer, read back by the JAX reader, give
  the JAX corpus's arrays; the same files, names and attributes."""
  assert sorted(os.listdir(port_corpus)) == sorted(os.listdir(jax_corpus))
  for (_, pp, ps), (_, jp, js) in zip(
      jax_nc.find_month_files(port_corpus, RES),
      jax_nc.find_month_files(jax_corpus, RES)):
    got, times, _, _ = jax_nc.read_month(pp, ps)
    want, w_times, _, _ = jax_nc.read_month(jp, js)
    _assert_tables_equal(got, want)
    np.testing.assert_array_equal(times, w_times)
  for name in os.listdir(jax_corpus):
    with h5py.File(os.path.join(port_corpus, name), 'r') as a, \
        h5py.File(os.path.join(jax_corpus, name), 'r') as b:
      assert list(a.keys()) == list(b.keys()), name
      assert dict(a.attrs) == dict(b.attrs), name
      for key in b.keys():
        np.testing.assert_array_equal(a[key][...], b[key][...])
        assert set(a[key].attrs) == set(b[key].attrs), (name, key)
        for attr in ('scale_factor', 'add_offset', '_FillValue', 'units'):
          if attr in b[key].attrs:
            assert a[key].attrs[attr] == b[key].attrs[attr]


def test_write_forecast_equals_the_jax_writer(tmp_path):
  task = registry.GENCAST_TASK
  lay = layout.build_layout(task.target_variables, task.pressure_levels, 1)
  jax_lay = jax_layout.build_layout(task.target_variables,
                                    task.pressure_levels, 1)
  rng = np.random.default_rng(0)
  lat, lon = np.linspace(-90, 90, 19), np.arange(0.0, 360.0, 10.0)
  preds = rng.standard_normal((2, 19, 36, lay.num_channels)).astype(
      np.float32)
  truth = rng.standard_normal(preds.shape).astype(np.float32)
  attrs = {'members': 2, 'steps': 2}
  paths = [str(tmp_path / 'port.nc'), str(tmp_path / 'jax.nc')]
  netcdf_writer.write_forecast(paths[0], preds, lay, lat, lon, truth=truth,
                               global_attrs=attrs)
  jax_writer.write_forecast(paths[1], preds, jax_lay, lat, lon, truth=truth,
                            global_attrs=attrs)
  with h5py.File(paths[0], 'r') as a, h5py.File(paths[1], 'r') as b:
    assert list(a.keys()) == list(b.keys())
    assert dict(a.attrs) == dict(b.attrs)
    for key in b.keys():
      assert a[key].dtype == b[key].dtype, key
      np.testing.assert_array_equal(a[key][...], b[key][...])
    np.testing.assert_array_equal(
        a['2m_temperature'][...],
        preds[..., lay.var_channels('2m_temperature')[0]])
    assert a['target_temperature'].shape == (2, 13, 19, 36)


def test_write_dataset_refuses_mismatched_dims(tmp_path):
  path = str(tmp_path / 'bad.nc')
  with pytest.raises(ValueError, match='unknown dim'):
    netcdf_writer.write_dataset(path, {'lat': np.zeros(3)},
                                {'x': (('lon',), np.zeros(3))})
  with pytest.raises(ValueError, match='has size 4'):
    netcdf_writer.write_dataset(path, {'lat': np.zeros(3)},
                                {'x': (('lat',), np.zeros(4))})
