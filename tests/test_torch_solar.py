"""The port's TOA incident solar radiation (`ops/solar.py`) and the sources
that pack it, against the JAX package on the CPU.

The JAX TISR runs its float32 trig through XLA, the port's through ATen:
the fields agree to 1e-5 of their maximum (about 50 J/m^2 of 5 MJ/m^2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.data import registry as jax_registry
from gencast_tpu.data import sources as jax_sources
from gencast_tpu.ops import solar as jax_solar
from gencast_tpu_torch.data import registry, sources
from gencast_tpu_torch.ops import solar
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TISR_RTOL = 1e-5
# 2020-01-01T00, a solstice noon, an equinox, 1959 (the table's first
# years) and 2040 (past its end): the hour angle, the declination and the
# TSI table's ends.
TIMES = np.array([1577836800.0, 1592827200.0, 1600776000.0 + 3600 * 7,
                  -347155200.0, 2208988800.0 + 1800])


def _grid(deg):
  return jax_configs.grid_for_resolution(deg)


@pytest.mark.parametrize('deg', [10.0, 30.0])
def test_tisr_equals_jax(deg):
  lat, lon = _grid(deg)
  want = np.asarray(jax_solar.tisr_for_grid(TIMES, lat, lon))
  got = solar.tisr_for_grid(TIMES, lat, lon)
  assert got.dtype == torch.float32 and got.shape == want.shape
  assert want.max() > 4e6 and want.min() == 0.0  # day and night
  err = np.abs(got.numpy() - want).max()
  assert err <= TISR_RTOL * np.abs(want).max(), err


def test_tisr_bands_do_not_change_the_field():
  """Bands of latitude rows (`max_elements`) bound the memory, not the
  values: any band size gives the same bits."""
  lat, lon = _grid(10.0)
  whole = solar.tisr_for_grid(TIMES[:2], lat, lon)
  for budget in (1, 361 * 36 * 3, 361 * 36 * 7):
    assert torch.equal(solar.tisr_for_grid(TIMES[:2], lat, lon,
                                           max_elements=budget), whole)


def test_tsi_and_pieces_equal_jax():
  np.testing.assert_allclose(solar.tsi_for_times(TIMES),
                             np.asarray(jax_solar.tsi_for_times(TIMES)),
                             rtol=1e-6)
  for a, b in zip(solar.era5_tsi_table(), jax_solar.era5_tsi_table()):
    np.testing.assert_array_equal(a, b)
  # One point, the flux and its hour integral at several day fractions.
  days = torch.full((4,), 7305.0)
  frac = torch.tensor([0.0, 0.25, 0.5, 0.75])
  args = (torch.tensor(0.5), torch.tensor(0.8660254), torch.tensor(1.0),
          torch.tensor(1361.0))
  got = solar.integrated_radiation(days, frac, *args)
  want = np.asarray(jax_solar.integrated_radiation(
      days.numpy(), frac.numpy(), *(a.numpy() for a in args)))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())


def test_graphcast_windows_equal_jax():
  """A GraphCast task's windows (TISR among the inputs and forcings) from
  the synthetic source equal the JAX source's, TISR within its tolerance
  and every other channel exactly; so do their statistics."""
  lat, lon = _grid(10.0)
  task = dataclasses.replace(registry.GRAPHCAST_TASK_13,
                             pressure_levels=(500, 850))
  jtask = dataclasses.replace(jax_registry.GRAPHCAST_TASK_13,
                              pressure_levels=(500, 850))
  port = sources.SyntheticSource(task, lat, lon, num_times=6, seed=2)
  ref = jax_sources.SyntheticSource(jtask, lat, lon, num_times=6, seed=2)
  tisr_in = port.input_layout.var_channels('toa_incident_solar_radiation')
  tisr_f = port.forcing_layout.var_channels('toa_incident_solar_radiation')
  w, v = port.sample(1, num_target_frames=2), ref.sample(
      1, num_target_frames=2)
  for name, chans in (('inputs', tisr_in), ('targets', []),
                      ('forcings', tisr_f)):
    got, want = getattr(w, name), getattr(v, name)
    assert got.shape == want.shape, name
    rest = np.setdiff1d(np.arange(got.shape[-1]), chans)
    np.testing.assert_array_equal(got[..., rest], want[..., rest],
                                  err_msg=name)
    if len(chans):
      scale = np.abs(want[..., chans]).max()
      assert np.abs(got[..., chans] - want[..., chans]).max() <= (
          TISR_RTOL * scale), name
  got, want = sources.compute_stats(port), jax_sources.compute_stats(ref)
  for table in ('mean', 'std', 'diffs_std'):
    for k, x in getattr(want, table).items():
      np.testing.assert_allclose(getattr(got, table)[k], x, rtol=1e-4,
                                 err_msg=f'{table}:{k}')
