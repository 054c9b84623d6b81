"""The port's host-side training data and loss functions against the JAX
package: the loss weights, losses, generated forcings, synthetic source,
batching and statistics, array for array."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.data import forcings as jax_forcings
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.data import registry as jax_registry
from gencast_tpu.data import sources as jax_sources
from gencast_tpu.models import gencast as jax_gencast
from gencast_tpu.ops import losses as jax_losses
from gencast_tpu_torch.data import forcings, layout, registry, sources
from gencast_tpu_torch.models import gencast
from gencast_tpu_torch.ops import losses
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TASKS = {'gencast': registry.GENCAST_TASK,
         'gencast_full': registry.GENCAST_TASK_FULL}


def _layouts(name):
  task, jtask = TASKS[name], jax_registry.TASKS[name]
  return (layout.build_layout(task.target_variables, task.pressure_levels, 1),
          jax_layout.build_layout(jtask.target_variables,
                                  jtask.pressure_levels, 1))


@pytest.mark.parametrize('task', sorted(TASKS))
def test_loss_channel_weights_equal_jax(task):
  port, ref = _layouts(task)
  assert gencast.LOSS_WEIGHTS_SURFACE == jax_gencast.LOSS_WEIGHTS_SURFACE
  got = layout.loss_channel_weights(port, gencast.LOSS_WEIGHTS_SURFACE)
  want = jax_layout.loss_channel_weights(ref,
                                         jax_gencast.LOSS_WEIGHTS_SURFACE)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)
  assert port.channels_per_var() == ref.channels_per_var()


def test_losses_match_jax():
  port, ref = _layouts('gencast_full')
  rng = np.random.default_rng(0)
  shape = (2, 19, 36, port.num_channels)
  pred, tgt = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(2))
  lat_w = jax_layout.latitude_weights(np.linspace(-90, 90, 19))
  chan_w, diag_w = jax_layout.loss_channel_weights(
      ref, jax_gencast.LOSS_WEIGHTS_SURFACE)
  scale = np.asarray([0.5, 3.0], np.float32)
  want = np.asarray(jax_losses.weighted_mse(
      jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(lat_w),
      jnp.asarray(chan_w), per_sample_scale=jnp.asarray(scale)))
  got = losses.weighted_mse(torch.as_tensor(pred), torch.as_tensor(tgt),
                            torch.as_tensor(lat_w), torch.as_tensor(chan_w),
                            per_sample_scale=torch.as_tensor(scale))
  # float32 means over 684 points in another order.
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
  want_d = jax_losses.per_variable_diagnostics(
      jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(lat_w), ref, diag_w)
  got_d = losses.per_variable_diagnostics(
      torch.as_tensor(pred), torch.as_tensor(tgt), torch.as_tensor(lat_w),
      port, diag_w)
  assert sorted(got_d) == sorted(want_d)
  for k in want_d:
    np.testing.assert_allclose(got_d[k].numpy(), np.asarray(want_d[k]),
                               rtol=1e-5)


def test_generated_forcings_equal_jax():
  t = 1.0e9 + 3600.0 * np.arange(7) * 5
  lat, lon = np.linspace(-90, 90, 19), np.arange(0, 360, 10.0)
  got = forcings.generated_forcings(t, lat, lon)
  want = jax_forcings.generated_forcings(t, lat, lon)
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k])
  np.testing.assert_array_equal(forcings.year_progress(t),
                                jax_forcings.year_progress(t))
  # TISR, refused until GraphCast was ported, is GraphCast's forcing:
  # within 1e-5 of the field's maximum of the JAX package's (float32 trig
  # on both sides; tests/test_torch_solar.py holds it closer).
  name = 'toa_incident_solar_radiation'
  got = forcings.all_forcings(t, lat, lon, [name])[name]
  want = jax_forcings.all_forcings(t, lat, lon, [name])[name]
  assert got.shape == want.shape and got.dtype == np.float32
  assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope='module')
def source_pair():
  lat, lon = jax_configs.grid_for_resolution(10.0)
  task, jtask = TASKS['gencast_full'], jax_registry.TASKS['gencast_full']
  return (sources.SyntheticSource(task, lat, lon, num_times=12, seed=3),
          jax_sources.SyntheticSource(jtask, lat, lon, num_times=12, seed=3))


def test_synthetic_source_equals_jax(source_pair):
  port, ref = source_pair
  assert len(port) == len(ref) == 10
  for index in (0, 7):
    got, want = port.sample(index), ref.sample(index)
    for name in ('inputs', 'targets', 'forcings'):
      np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.timestamp == want.timestamp
  # SST is NaN over land, as in the reference (the CLI's --clean_sst_nans).
  sst = port.target_layout.var_channels('sea_surface_temperature')
  assert np.isnan(port.sample(0).targets[..., sst]).any()


def test_batches_and_stats_equal_jax(source_pair):
  port, ref = source_pair
  got = sources.batch_iterator(port, 2, seed=5)
  want = jax_sources.batch_iterator(ref, 2, seed=5)
  for _ in range(2):
    g, w = next(got), next(want)
    for k in ('inputs', 'targets', 'forcings'):
      np.testing.assert_array_equal(g[k], w[k])
  got_s, want_s = sources.compute_stats(port), jax_sources.compute_stats(ref)
  for table in ('mean', 'std', 'diffs_std'):
    g, w = getattr(got_s, table), getattr(want_s, table)
    assert sorted(g) == sorted(w)
    for k in w:
      np.testing.assert_array_equal(g[k], w[k])


def test_pack_equals_jax():
  task = TASKS['gencast']
  lay = layout.build_layout(task.input_variables, task.pressure_levels, 2)
  jlay = jax_layout.build_layout(task.input_variables, task.pressure_levels,
                                 2)
  rng = np.random.default_rng(1)
  nl = len(task.pressure_levels)
  fields = {}
  for name in lay.var_names:
    if registry.is_static(name):
      shape = (5, 6)
    elif registry.is_atmospheric(name):
      shape = (3, 2, nl, 5, 6)
    else:
      shape = (3, 2, 5, 6)
    fields[name] = rng.standard_normal(shape).astype(np.float32)
  got = layout.pack(fields, lay)
  want = np.asarray(jax_layout.pack(
      {k: jnp.asarray(v) for k, v in fields.items()}, jlay))
  assert got.shape == (3, 5, 6, lay.num_channels)
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('k', [1, 3])
def test_packer_windows_of_k_frames_equal_in_process(k):
  """The worker packer with num_target_frames=K: one unshuffled pass of
  batch 1 holds len(source) - (K - 1) windows, each bitwise the in-process
  source.sample(i, num_target_frames=K)."""
  from gencast_tpu_torch.data.workers import ParallelBatchIterator
  lat, lon = jax_configs.grid_for_resolution(30.0)
  factory = functools.partial(sources.SyntheticSource, TASKS['gencast'],
                              lat, lon, num_times=8, seed=3)
  source = factory()
  with ParallelBatchIterator(factory, 1, num_workers=1, shuffle=False,
                             loop=False, num_target_frames=k) as it:
    got = list(it)
  assert len(got) == len(source) - (k - 1)
  for i, batch in enumerate(got):
    want = source.sample(i, num_target_frames=k)
    for name in ('inputs', 'targets', 'forcings'):
      g, w = batch[name][0], getattr(want, name)
      assert g.shape == w.shape and g.dtype == w.dtype, name
      assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), (i, name)
  with pytest.raises(ValueError, match='num_target_frames'):
    ParallelBatchIterator(factory, 1, num_workers=1, num_target_frames=0)
