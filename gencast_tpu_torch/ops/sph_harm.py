"""Real spherical harmonics on lat/lon grids: isotropic noise on the sphere.

Counterpart of `gencast_tpu.ops.sph_harm` for float32 bases. The Legendre
table is built in numpy (float64 recursion, stored float32; at 1 degree
max_l = 179 and the table is [180, 180, 181], 23 MB). Synthesis is two
dense contractions, Legendre over total wavenumber l, then Fourier over
zonal wavenumber m, which stay plain torch.einsum products.

Conventions (as the reference): orthonormal real spherical harmonics
  Y_{l0}        = Q_{l0}(x)
  Y_{lm}^{cos}  = sqrt(2) Q_{lm}(x) cos(m phi),  m >= 1
  Y_{lm}^{sin}  = sqrt(2) Q_{lm}(x) sin(m phi)
with Q_{lm} = N_{lm} P_l^m. Coefficients iid N(0, 4 pi power_l / (2l+1))
give noise of pointwise variance sum_l power_l and rotation-invariant law.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch


def legendre_table(x: np.ndarray, max_l: int) -> np.ndarray:
  """Normalized associated Legendre values, shape [L+1, L+1, len(x)].

  Entry [l, m, j] is sqrt(2 - delta_{m0}) * N_{lm} P_l^m(x_j) with
  N_{lm} = sqrt((2l+1)/(4pi) (l-m)!/(l+m)!) and the Condon-Shortley phase.
  Entries with m > l are zero. Stable normalized recursions, vectorized
  over x, in float64.
  """
  x = np.asarray(x, dtype=np.float64)
  nx = x.shape[0]
  lmax = max_l
  p = np.zeros((lmax + 1, lmax + 1, nx), dtype=np.float64)
  s = np.sqrt(np.maximum(0.0, 1.0 - x * x))  # sin(theta)

  # Diagonal: Q_{mm} (sequential in m).
  p[0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
  for m in range(1, lmax + 1):
    p[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * s * p[m - 1, m - 1]

  # Upward recursion in l, vectorized over all m < l.
  for l in range(1, lmax + 1):
    # First off-diagonal: Q_{l, l-1} = x sqrt(2l+1) Q_{l-1, l-1}.
    p[l, l - 1] = x * np.sqrt(2.0 * l + 1.0) * p[l - 1, l - 1]
    if l >= 2:
      m = np.arange(l - 1, dtype=np.float64)
      a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
      b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
      p[l, :l - 1] = a[:, None] * (x[None, :] * p[l - 1, :l - 1]
                                   - b[:, None] * p[l - 2, :l - 1])

  # Fold in sqrt(2) for m >= 1 (real-harmonic normalization).
  p[:, 1:] *= np.sqrt(2.0)
  return p


@dataclasses.dataclass(frozen=True)
class SphericalHarmonicBasis:
  """Synthesis operators for a fixed lat/lon grid (numpy, float32).

  legendre: [L+1, L+1, num_lat]  (l, m, lat)
  fourier:  [2, L+1, num_lon]    (cos(m phi), sin(m phi))
  """
  legendre: np.ndarray
  fourier: np.ndarray
  max_l: int


def basis_for_grid(lat_deg: Sequence[float], lon_deg: Sequence[float],
                   max_l: int | None = None) -> SphericalHarmonicBasis:
  """Basis resolving wavenumbers up to max_l (default num_lon // 2 - 1, the
  most the grid resolves, as the reference)."""
  lat = np.asarray(lat_deg, dtype=np.float64)
  lon = np.asarray(lon_deg, dtype=np.float64)
  if max_l is None:
    max_l = len(lon) // 2 - 1
  leg = legendre_table(np.sin(np.deg2rad(lat)), max_l)
  phi = np.deg2rad(lon)
  m = np.arange(max_l + 1)[:, None]
  four = np.stack([np.cos(m * phi[None]), np.sin(m * phi[None])])
  return SphericalHarmonicBasis(legendre=leg.astype(np.float32),
                                fourier=four.astype(np.float32), max_l=max_l)


def synthesize(coeffs: torch.Tensor, legendre: torch.Tensor,
               fourier: torch.Tensor) -> torch.Tensor:
  """Inverse transform: [..., 2, L+1, L+1] (s=cos/sin, l, m) -> [..., lat, lon]."""
  g = torch.einsum('...slm,lmj->...smj', coeffs, legendre)
  return torch.einsum('...smj,smi->...ji', g, fourier)


def unit_white_noise(generator: torch.Generator, batch_shape: Tuple[int, ...],
                     legendre: torch.Tensor, fourier: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
  """Unit-marginal-variance isotropic noise with a flat power spectrum,
  [*batch_shape, lat, lon], drawn from `generator` on its device."""
  n = legendre.shape[0]  # L + 1
  device = legendre.device
  l_idx = torch.arange(n, device=device)
  # Flat spectrum power_l = 1 / n; valid coefficients: m <= l, and for
  # m == 0 only the cos (s=0) entry.
  sigma_l = torch.sqrt(4.0 * math.pi / n / (2.0 * l_idx + 1.0))
  tri = (l_idx[None, :] <= l_idx[:, None]).float()
  mask = torch.stack([tri, tri * (l_idx[None, :] > 0)])
  scale = mask * sigma_l[None, :, None]
  z = torch.randn(tuple(batch_shape) + tuple(scale.shape),
                  generator=generator, device=generator.device)
  return synthesize(z.to(device) * scale, legendre, fourier).to(dtype)
