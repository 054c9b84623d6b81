"""Real spherical harmonics on lat/lon grids: isotropic noise on the sphere.

Counterpart of `gencast_tpu.ops.sph_harm`. The Legendre table is built in
numpy (float64 recursion; at 1 degree max_l = 179 and the float32 table is
[180, 180, 181], 23 MB) or, for a large table stored in bf16 (0.25
degrees: max_l = 719, [720, 720, 721], 747 MB in bf16 where the float64
table is 3 GB of host work), by a scaled float32 recursion on the device
(`legendre_table_device`). Synthesis is two dense contractions, Legendre
over total wavenumber l, then Fourier over zonal wavenumber m, plain
torch.einsum products that sum in float32 whatever the basis dtype.

Conventions (as the reference): orthonormal real spherical harmonics
  Y_{l0}        = Q_{l0}(x)
  Y_{lm}^{cos}  = sqrt(2) Q_{lm}(x) cos(m phi),  m >= 1
  Y_{lm}^{sin}  = sqrt(2) Q_{lm}(x) sin(m phi)
with Q_{lm} = N_{lm} P_l^m. Coefficients iid N(0, 4 pi power_l / (2l+1))
give noise of pointwise variance sum_l power_l and rotation-invariant law.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Sequence, Tuple

import numpy as np
import torch

# Tables at or above this max_l stored in a dtype narrower than 4 bytes are
# computed on the device (`legendre_table_device`), as in the reference:
# the float32 recursion drifts ~1.5e-3 of the table's largest value at
# L = 719, under bf16's rounding, so float32 bases keep the float64 host
# table at any size. GENCAST_SH_DEVICE_TABLE=0/1 forces the choice; it is
# read by `basis_for_grid`, so it is part of the basis cache's key.
_DEVICE_TABLE_MIN_L = 256
# Zonal wavenumbers per float32 slice of a narrower Legendre table in
# `synthesize`: the transient float32 copy stays [L+1, 64, lat].
_SYNTH_M_SLICE = 64


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


def legendre_table_device(x: np.ndarray, max_l: int, dtype: torch.dtype,
                          device: torch.device | str = 'cpu'
                          ) -> torch.Tensor:
  """`legendre_table` computed by a scaled float32 recursion on `device`,
  returned in `dtype` (the reference's `legendre_table_device`).

  The plain float32 recursion underflows: the diagonal seed Q_mm ~ s^m
  (s = sin theta) reaches 1e-39 near the poles long before l brings the
  values back to O(1). So it recurses on u_lm = Q_lm / s^m, whose seeds
  c_m are O(m^(1/4)), carrying a power-of-two exponent per (m, lat) that
  is renormalized whenever |u| leaves [2^-64, 2^64]; s^m and the exponent
  are applied in exponent space when a row is emitted. Each step of the
  loop over l is a few elementwise ops on [L+1, lat] and emits its
  finished row, so the float32 working set is three rows. Powers of two
  are applied as two half-exponent factors, so that no factor is
  subnormal where the product is not.

  Accuracy against the float64 table (max abs error / table max): 2.4e-4
  at L = 300, 1.5e-3 at L = 719, below bf16's rounding of the stored table.
  """
  dev = torch.device(device)
  f32 = torch.float32
  lmax = max_l
  x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
  nx = x.shape[0]
  s = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))

  # Scaled diagonal seeds c_m = Q_mm / s^m (a cumulative product of O(1)
  # factors).
  mf = torch.arange(1, lmax + 1, dtype=f32, device=dev)[:, None]
  d0 = torch.full((1, nx), 1.0 / math.sqrt(4.0 * math.pi), dtype=f32,
                  device=dev)
  c = torch.cat([d0, d0 * torch.cumprod(
      (-torch.sqrt((2.0 * mf + 1.0) / (2.0 * mf))).expand(lmax, nx),
      dim=0)], dim=0)

  m_idx = torch.arange(lmax + 1, dtype=f32, device=dev)
  # log2(s^m), with the m = 0 column pinned to 0 (0 * log2(0) is nan).
  pole = torch.where(
      m_idx[:, None] > 0,
      m_idx[:, None] * torch.log2(torch.clamp(s, min=1e-30))[None, :],
      torch.zeros((), dtype=f32, device=dev))
  # The sqrt(2) real-harmonic fold for m >= 1.
  fold = torch.where(m_idx > 0, math.sqrt(2.0), 1.0)[:, None].to(f32)

  out = torch.empty((lmax + 1, lmax + 1, nx), dtype=dtype, device=dev)

  def emit(l, u, e):
    # Q = u * 2^(e + m log2 s), as (u * f) * f with f = 2^((e + ...) / 2).
    f = torch.exp2((e + pole) * 0.5)
    out[l] = (u * f * f * fold).to(dtype)

  row0 = torch.zeros((lmax + 1, nx), dtype=f32, device=dev)
  row0[0] = d0[0]
  e = torch.zeros_like(row0)
  emit(0, row0, e)
  u1, u2 = row0, torch.zeros_like(row0)
  for l in range(1, lmax + 1):
    # The coefficients in float32, as the reference computes them.
    lf = torch.tensor(float(l), dtype=f32, device=dev)
    # The three-term upward recursion; b vanishes at m = l - 1, so the first
    # off-diagonal needs no case of its own. Columns m >= l are masked (a
    # is nan there).
    a = torch.sqrt((4.0 * lf * lf - 1.0) / (lf * lf - m_idx * m_idx))
    b = torch.sqrt(((lf - 1.0) ** 2 - m_idx * m_idx)
                   / (4.0 * (lf - 1.0) ** 2 - 1.0))
    u = a[:, None] * (x[None, :] * u1 - b[:, None] * u2)
    u = torch.where((m_idx < lf)[:, None], u, 0.0)
    u[l] = c[l]
    # Joint renormalization of (u, u1) keeping |u| in [2^-64, 2^64];
    # columns still exactly zero (not reached yet) are left alone.
    mx = torch.maximum(u.abs(), u1.abs())
    shift = torch.where((mx > 0.0) & (mx < 2.0 ** -64), 128.0,
                        torch.where(mx > 2.0 ** 64, -128.0, 0.0))
    half = torch.exp2(shift * 0.5)
    emit(l, u, e)
    u2, u1, e = u1 * half * half, u * half * half, e - shift
  return out


@dataclasses.dataclass(frozen=True)
class SphericalHarmonicBasis:
  """Synthesis operators for a fixed lat/lon grid, on one device.

  legendre: [L+1, L+1, num_lat]  (l, m, lat)
  fourier:  [2, L+1, num_lon]    (cos(m phi), sin(m phi))
  both in the basis dtype.
  """
  legendre: torch.Tensor
  fourier: torch.Tensor
  max_l: int


@functools.lru_cache(maxsize=4)
def _basis_cached(lat_key: Tuple[float, ...], lon_key: Tuple[float, ...],
                  max_l: int, dtype: torch.dtype, on_device: bool,
                  device: torch.device) -> SphericalHarmonicBasis:
  x = np.sin(np.deg2rad(np.asarray(lat_key)))
  if on_device:
    leg = legendre_table_device(x, max_l, dtype, device)
  else:
    leg = torch.as_tensor(legendre_table(x, max_l)).to(device, dtype)
  phi = np.deg2rad(np.asarray(lon_key))
  m = np.arange(max_l + 1)[:, None]
  four = np.stack([np.cos(m * phi[None]), np.sin(m * phi[None])])
  return SphericalHarmonicBasis(
      legendre=leg, fourier=torch.as_tensor(four).to(device, dtype),
      max_l=max_l)


def basis_for_grid(lat_deg: Sequence[float], lon_deg: Sequence[float],
                   max_l: int | None = None, dtype=torch.float32,
                   device: torch.device | str = 'cpu'
                   ) -> SphericalHarmonicBasis:
  """Basis resolving wavenumbers up to max_l (default num_lon // 2 - 1, the
  most the grid resolves, as the reference), stored in `dtype` on
  `device`. The Legendre table comes from the device recursion when
  max_l >= 256 and `dtype` is narrower than 4 bytes (or as
  GENCAST_SH_DEVICE_TABLE=0/1 says), else from the float64 host table.
  Bases are cached by their arguments and the switch (the models of one
  grid share their tensors, which nothing writes)."""
  lat = tuple(float(v) for v in lat_deg)
  lon = tuple(float(v) for v in lon_deg)
  if max_l is None:
    max_l = len(lon) // 2 - 1
  env = os.environ.get('GENCAST_SH_DEVICE_TABLE')
  if env is not None:
    on_device = bool(int(env))
  else:
    on_device = (max_l >= _DEVICE_TABLE_MIN_L
                 and torch.finfo(dtype).bits < 32)
  device = torch.device(device)
  if device.type == 'cuda' and device.index is None:
    # 'cuda' and 'cuda:0' name one card: one cache entry.
    device = torch.device('cuda', torch.cuda.current_device())
  return _basis_cached(lat, lon, max_l, dtype, on_device, device)


def synthesize(coeffs: torch.Tensor, legendre: torch.Tensor,
               fourier: torch.Tensor) -> torch.Tensor:
  """Inverse transform: [..., 2, L+1, L+1] (s=cos/sin, l, m) -> [..., lat, lon].

  With a basis narrower than the coefficients (bf16), as the reference: the
  coefficients are rounded to the basis dtype, each contraction sums in
  float32 and its result is rounded to the basis dtype before the next; the
  output has the coefficients' dtype. The table is widened to float32 a
  slice of zonal wavenumbers at a time, so no float32 copy of it is made.
  """
  bt = legendre.dtype
  if bt == coeffs.dtype:
    g = torch.einsum('...slm,lmj->...smj', coeffs, legendre)
    return torch.einsum('...smj,smi->...ji', g, fourier)
  c = coeffs.to(bt).float()
  n_m = legendre.shape[1]
  g = torch.cat([
      torch.einsum('...slm,lmj->...smj', c[..., lo:lo + _SYNTH_M_SLICE],
                   legendre[:, lo:lo + _SYNTH_M_SLICE].float())
      for lo in range(0, n_m, _SYNTH_M_SLICE)], dim=-2)
  out = torch.einsum('...smj,smi->...ji', g.to(bt).float(), fourier.float())
  return out.to(coeffs.dtype)


def sample_isotropic(generator: torch.Generator, power_spectrum,
                     batch_shape: Tuple[int, ...],
                     basis: SphericalHarmonicBasis,
                     dtype=torch.float32) -> torch.Tensor:
  """Isotropic noise with the given spectrum, [*batch_shape, lat, lon],
  drawn from `generator` on its device.

  power_spectrum: the power per total wavenumber l, a [L+1] tensor or one
  number for a flat spectrum; the pointwise marginal variance of the result
  is the spectrum's sum."""
  legendre, fourier = basis.legendre, basis.fourier
  n = legendre.shape[0]  # L + 1
  device = legendre.device
  l_idx = torch.arange(n, device=device)
  if isinstance(power_spectrum, torch.Tensor):
    power_spectrum = power_spectrum.to(device, torch.float32)
  # Std per l; valid coefficients: m <= l, and for m == 0 only the cos
  # (s=0) entry.
  sigma_l = torch.sqrt(4.0 * math.pi * power_spectrum
                       / (2.0 * l_idx + 1.0))
  tri = (l_idx[None, :] <= l_idx[:, None]).float()
  mask = torch.stack([tri, tri * (l_idx[None, :] > 0)])
  scale = mask * sigma_l[None, :, None]
  z = torch.randn(tuple(batch_shape) + tuple(scale.shape),
                  generator=generator, device=generator.device)
  return synthesize(z.to(device) * scale, legendre, fourier).to(dtype)


def unit_white_noise(generator: torch.Generator, batch_shape: Tuple[int, ...],
                     legendre: torch.Tensor, fourier: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
  """Unit-marginal-variance isotropic noise with a flat power spectrum,
  [*batch_shape, lat, lon], drawn from `generator` on its device: the
  spectrum 1 / (L+1) at every l, passed as a number, so that the std per l
  is computed as it always was (the sampler's noise keeps its bits)."""
  basis = SphericalHarmonicBasis(legendre=legendre, fourier=fourier,
                                 max_l=legendre.shape[0] - 1)
  return sample_isotropic(generator, 1.0 / legendre.shape[0], batch_shape,
                          basis, dtype)
