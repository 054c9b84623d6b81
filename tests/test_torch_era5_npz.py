"""The npz shard layout (`sources.Era5NpzSource`): the card's ERA5 path.

The card's machine has no h5py, so its ERA5 directories are npz shards.
The port's `tools.synth_era5 --layout npz` must write exactly what the JAX
package's `tools/synth_era5.py` followed by its `tools/convert_era5.py`
writes (every array bit for bit, the manifest equal), the port's
converter what the JAX converter writes, and the port's `Era5NpzSource`
the JAX source's windows.
"""

import json
import os
import sys

import numpy as np
import pytest

h5py = pytest.importorskip('h5py')

from gencast_tpu.data import registry as jax_registry  # noqa: E402
from gencast_tpu.data import sources as jax_sources  # noqa: E402
from gencast_tpu_torch.data import registry, sources  # noqa: E402
from gencast_tpu_torch.tools import convert_era5, synth_era5  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

MONTHS = ('202001', '202002')
STEPS = 5


def _jax_convert(inp, out, resolution):
  """The JAX package's converter, a script that reads sys.argv."""
  from tools import convert_era5 as jax_convert
  argv = sys.argv
  sys.argv = ['convert_era5.py', '--in', inp, '--out', out, '--resolution',
              str(resolution)]
  try:
    jax_convert.main()
  finally:
    sys.argv = argv


@pytest.fixture(scope='module', params=[10.0, 2.5], ids=['10deg', '2.5deg'])
def corpora(request, tmp_path_factory):
  """{layout name: directory} at one resolution: the JAX corpus, its JAX
  conversion, the port's npz synthesis and the port's conversion of the
  JAX corpus."""
  from tools import synth_era5 as jax_synth
  res = request.param
  root = tmp_path_factory.mktemp(f'npz_{res}')
  dirs = {k: str(root / k) for k in ('jax_nc', 'jax_npz', 'port_npz',
                                     'port_conv')}
  jax_synth.synthesize(dirs['jax_nc'], resolution_deg=res, months=MONTHS,
                       steps_per_month=STEPS, seed=5)
  _jax_convert(dirs['jax_nc'], dirs['jax_npz'], res)
  synth_era5.synthesize(dirs['port_npz'], resolution_deg=res, months=MONTHS,
                        steps_per_month=STEPS, seed=5, layout='npz')
  convert_era5.main(['--in', dirs['jax_nc'], '--out', dirs['port_conv'],
                     '--resolution', str(res)])
  return res, dirs


def _assert_same_shards(got_dir, want_dir):
  assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
  for name in sorted(os.listdir(want_dir)):
    path_a, path_b = os.path.join(got_dir, name), os.path.join(want_dir, name)
    if name.endswith('.json'):
      with open(path_a) as a, open(path_b) as b:
        assert json.load(a) == json.load(b)
      continue
    with np.load(path_a) as a, np.load(path_b) as b:
      assert a.files == b.files, name
      for key in b.files:
        assert a[key].dtype == b[key].dtype, (name, key)
        np.testing.assert_array_equal(a[key], b[key], err_msg=f'{name} {key}')


@pytest.mark.parametrize('layout', ['port_npz', 'port_conv'])
def test_shards_equal_the_jax_synth_then_convert(corpora, layout):
  _, dirs = corpora
  _assert_same_shards(dirs[layout], dirs['jax_npz'])


def test_shards_hold_the_standardized_variables(corpora):
  res, dirs = corpora
  with open(os.path.join(dirs['port_npz'], 'manifest.json')) as f:
    manifest = json.load(f)
  assert manifest['months'] == list(MONTHS)
  assert manifest['pressure_levels'] == list(
      registry.PRESSURE_LEVELS_WEATHERBENCH_13)
  lat = np.asarray(manifest['lat'])
  assert lat[0] == -90.0 and lat[-1] == 90.0 and lat.size == round(180 / res) + 1
  with np.load(os.path.join(dirs['port_npz'], 'era5_202001.npz')) as z:
    assert z['temperature'].shape == (STEPS, 13, lat.size,
                                      len(manifest['lon']))
    assert (z['total_precipitation_12hr'][0] == 0).all()
    assert np.isnan(z['sea_surface_temperature']).any()
    np.testing.assert_array_equal(
        np.diff(z['timestamps']), np.full(STEPS - 1, 12 * 3600.0))


def test_npz_source_windows_equal_the_jax_source(corpora):
  _, dirs = corpora
  src = sources.Era5NpzSource(dirs['port_npz'], registry.GENCAST_TASK)
  ref = jax_sources.Era5NpzSource(dirs['jax_npz'],
                                  jax_registry.GENCAST_TASK)
  assert len(src) == len(ref) == len(MONTHS) * STEPS - 2
  np.testing.assert_array_equal(src.lat, ref.lat)
  np.testing.assert_array_equal(src.lon, ref.lon)
  for index, frames in ((0, 1), (STEPS - 2, 1), (2, 3)):
    got, want = src.sample(index, frames), ref.sample(index, frames)
    for part in ('inputs', 'targets', 'forcings'):
      np.testing.assert_array_equal(getattr(got, part), getattr(want, part),
                                    err_msg=f'{index} {part}')


def test_npz_and_netcdf_sources_give_the_same_windows(corpora):
  """The two layouts of one corpus are the same data to the model."""
  from gencast_tpu_torch.data import era5_netcdf
  res, dirs = corpora
  task = registry.GENCAST_TASK
  npz = sources.Era5NpzSource(dirs['port_npz'], task)
  nc = era5_netcdf.Era5NetCDFSource(dirs['jax_nc'], task, resolution_deg=res)
  for index in (0, len(npz) - 1):
    a, b = npz.sample(index), nc.sample(index)
    for part in ('inputs', 'targets', 'forcings'):
      np.testing.assert_array_equal(getattr(a, part), getattr(b, part))


def test_npz_source_refuses_a_directory_without_shards(tmp_path, corpora):
  _, dirs = corpora
  for name in ('manifest.json', 'statics.npz'):
    with open(os.path.join(dirs['port_npz'], name), 'rb') as f, \
        open(tmp_path / name, 'wb') as g:
      g.write(f.read())
  with pytest.raises(FileNotFoundError, match='no era5_'):
    sources.Era5NpzSource(str(tmp_path), registry.GENCAST_TASK)


def test_npz_layout_needs_no_h5py(tmp_path, monkeypatch):
  """The card's machine has no h5py: the npz synthesis and source must not
  import it (the NetCDF layout does, and fails clearly without it)."""
  monkeypatch.setitem(sys.modules, 'h5py', None)
  out = str(tmp_path / 'npz')
  synth_era5.synthesize(out, resolution_deg=30.0, steps_per_month=3,
                        layout='npz')
  src = sources.Era5NpzSource(out, registry.GENCAST_TASK)
  assert len(src) == 1 and np.isfinite(src.sample(0).targets[..., 0]).all()
  with pytest.raises(ImportError):
    synth_era5.synthesize(str(tmp_path / 'nc'), resolution_deg=30.0,
                          steps_per_month=3)
  with pytest.raises(ValueError, match='layout'):
    synth_era5.synthesize(str(tmp_path / 'x'), layout='zarr')
