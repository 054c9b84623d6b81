"""The port's spherical-harmonic noise (`gencast_tpu_torch.ops.sph_harm`):
`sample_isotropic` against the JAX package's with its normals injected,
the marginal variance of a spectrum, and `unit_white_noise`'s bits against
a golden written by the code before `sample_isotropic` existed."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.ops import sph_harm as jax_sph_harm
from gencast_tpu_torch.ops import sph_harm
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens',
                      'torch_unit_white_noise.npz')
# float32 synthesis of the same coefficients in another summation order.
RTOL = 1e-5


def _grid(step, lo=-90.0):
  return (np.arange(lo, 90.0 + 1e-6, step), np.arange(0.0, 360.0, step))


@pytest.mark.parametrize('spectrum', ['red', 'one_band'])
def test_sample_isotropic_matches_jax_with_its_normals(spectrum,
                                                      monkeypatch):
  lat, lon = _grid(10.0)
  jbasis = jax_sph_harm.basis_for_grid(lat, lon)
  basis = sph_harm.basis_for_grid(lat, lon)
  n = basis.max_l + 1
  power = (1.0 / (1.0 + np.arange(n)) ** 2 if spectrum == 'red'
           else np.where(np.arange(n) == 5, 3.0, 0.0)).astype(np.float32)
  key = jax.random.PRNGKey(4)
  want = np.asarray(jax_sph_harm.sample_isotropic(
      key, jnp.asarray(power), (3,), jbasis))
  normals = torch.as_tensor(np.array(
      jax.random.normal(key, (3, 2, n, n), jnp.float32)))
  drawn = []

  def randn(shape, generator=None, device=None):
    drawn.append(tuple(shape))
    return normals

  monkeypatch.setattr(torch, 'randn', randn)
  got = sph_harm.sample_isotropic(torch.Generator(), torch.as_tensor(power),
                                  (3,), basis).numpy()
  assert drawn == [(3, 2, n, n)]
  assert got.shape == want.shape == (3, lat.size, lon.size)
  assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_sample_isotropic_respects_spectrum_power():
  """All the power at l = 3: the pointwise variance is that power (the
  JAX package's tests/test_sph_harm.py check, on the port)."""
  lat, lon = _grid(10.0, lo=-85.0)
  basis = sph_harm.basis_for_grid(lat, lon)
  power = torch.zeros(basis.max_l + 1)
  power[3] = 2.0
  noise = sph_harm.sample_isotropic(torch.Generator().manual_seed(1), power,
                                    (4000,), basis)
  assert noise.shape == (4000, lat.size, lon.size)
  assert abs(float(noise.var()) - 2.0) < 0.1


@pytest.mark.parametrize('name', ['deg10', 'deg30', 'deg10_bf16'])
def test_unit_white_noise_keeps_its_bits(name):
  """unit_white_noise, now a call into sample_isotropic, draws the bits it
  drew before (the sampler's noise and every test of it depend on them)."""
  lat, lon = _grid(10.0 if name.startswith('deg10') else 30.0)
  dtype = torch.bfloat16 if name.endswith('bf16') else torch.float32
  basis = sph_harm.basis_for_grid(lat, lon, dtype=dtype)
  got = sph_harm.unit_white_noise(torch.Generator().manual_seed(11), (2,),
                                  basis.legendre, basis.fourier).numpy()
  want = np.load(GOLDEN)[name]
  assert got.shape == want.shape
  assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
