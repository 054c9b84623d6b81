"""DeepMind's published normalization statistics in the port
(`sources.load_stats_netcdf`, `load_stats_auto`) against the JAX package's
loader, on directories the port's and the JAX package's
`synthesize_stats` write in the published structure (level vectors for
atmospheric variables, 0-d scalars for the others)."""

import os

import numpy as np
import pytest

h5py = pytest.importorskip('h5py')

from gencast_tpu.data import sources as jax_sources  # noqa: E402
from gencast_tpu_torch.data import layout, registry, sources  # noqa: E402
from gencast_tpu_torch.tools import synth_era5  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

LEVELS_6 = (100, 250, 500, 700, 850, 1000)


@pytest.fixture(scope='module')
def stats_dirs(tmp_path_factory):
  from tools import synth_era5 as jax_synth
  root = tmp_path_factory.mktemp('stats')
  dirs = {k: str(root / k) for k in ('port', 'jax', 'port_unprefixed')}
  synth_era5.synthesize_stats(dirs['port'], seed=7)
  jax_synth.synthesize_stats(dirs['jax'], seed=7)
  synth_era5.synthesize_stats(dirs['port_unprefixed'], seed=7, prefix='')
  return dirs


def _assert_stats_equal(a, b):
  for table in ('mean', 'std', 'diffs_std'):
    ta, tb = getattr(a, table), getattr(b, table)
    assert list(ta) == list(tb), table
    for name in tb:
      assert np.asarray(ta[name]).dtype == np.asarray(tb[name]).dtype
      np.testing.assert_array_equal(ta[name], tb[name], err_msg=name)


@pytest.mark.parametrize('levels', [None, LEVELS_6,
                                    registry.GENCAST_TASK.pressure_levels])
def test_published_stats_equal_the_jax_loader(stats_dirs, levels):
  got = sources.load_stats_netcdf(stats_dirs['jax'], levels)
  _assert_stats_equal(got, jax_sources.load_stats_netcdf(stats_dirs['jax'],
                                                         levels))
  # The port's synthesized directory is the JAX one, file for file.
  _assert_stats_equal(sources.load_stats_netcdf(stats_dirs['port'], levels),
                      got)
  n = 13 if levels is None else len(levels)
  assert got.mean['temperature'].shape == (n,)
  assert got.mean['2m_temperature'].shape == ()


def test_levels_are_selected_by_position(stats_dirs):
  full = sources.load_stats_netcdf(stats_dirs['port'], None)
  six = sources.load_stats_netcdf(stats_dirs['port'], LEVELS_6)
  lvl13 = list(registry.PRESSURE_LEVELS_WEATHERBENCH_13)
  sel = [lvl13.index(l) for l in LEVELS_6]
  np.testing.assert_array_equal(six.std['geopotential'],
                                full.std['geopotential'][sel])


def test_a_missing_level_is_refused_not_substituted(stats_dirs):
  for loader in (sources.load_stats_netcdf, jax_sources.load_stats_netcdf):
    with pytest.raises(ValueError, match='125'):
      loader(stats_dirs['port'], (125, 500, 850))


def test_graphcasts_unprefixed_names_are_read(stats_dirs):
  got = sources.load_stats_netcdf(stats_dirs['port_unprefixed'], LEVELS_6)
  _assert_stats_equal(got, sources.load_stats_netcdf(stats_dirs['port'],
                                                     LEVELS_6))


def test_a_directory_without_stats_names_what_it_expected(tmp_path):
  with pytest.raises(FileNotFoundError, match='gencast_stats_mean_by_level'):
    sources.load_stats_netcdf(str(tmp_path))


def test_load_stats_auto_picks_by_path(stats_dirs, tmp_path):
  """A directory is read as published NetCDF stats, a file as the npz of
  `save_stats`; both feed the channel vectors."""
  task = registry.GENCAST_TASK
  published = sources.load_stats_auto(stats_dirs['port'],
                                      task.pressure_levels)
  _assert_stats_equal(published, sources.load_stats_netcdf(
      stats_dirs['port'], task.pressure_levels))
  path = str(tmp_path / 'stats.npz')
  sources.save_stats(published, path)
  _assert_stats_equal(sources.load_stats_auto(path), published)
  lay = layout.build_layout(task.target_variables, task.pressure_levels, 1)
  scales = layout.channel_scales(lay, published)
  assert scales.shape == (lay.num_channels,) and (scales > 0).all()
  assert os.path.isdir(stats_dirs['port'])
