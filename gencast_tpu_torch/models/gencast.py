"""GenCast: EDM-preconditioned diffusion forecasting and its sampler.

Counterpart of `gencast_tpu.models.gencast`: the preconditioned denoiser,
its EDM training loss, and the DPM-Solver++ 2S sampler with stochastic
churn. A forecast step makes 2N - 1 denoiser calls: a 2S step (two calls)
for each of the first N - 1 noise levels, then a single Euler step at the
last level. The loss makes one denoiser call, as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data.registry import TaskSpec
from gencast_tpu_torch.graph.compiler import GraphStatics
from gencast_tpu_torch.models import diffusion_utils
from gencast_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from gencast_tpu_torch.nn.transformer import TransformerConfig
from gencast_tpu_torch.ops import losses, sph_harm


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
  """Sampling-time schedule (the reference's defaults)."""
  max_noise_level: float = 80.0
  min_noise_level: float = 0.03
  num_noise_levels: int = 20
  rho: float = 7.0
  stochastic_churn_rate: float = 2.5
  churn_min_noise_level: float = 0.75
  churn_max_noise_level: float = float('inf')
  noise_level_inflation_factor: float = 1.05


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
  """Training-time noise-level distribution (the reference's defaults)."""
  training_noise_level_rho: float = 7.0
  training_max_noise_level: float = 88.0
  training_min_noise_level: float = 0.02


# Loss weight per surface variable; atmospheric variables weigh 1.0 (the
# reference's LOSS_WEIGHTS_SURFACE).
LOSS_WEIGHTS_SURFACE = {
    '2m_temperature': 1.0,
    '10m_u_component_of_wind': 0.1,
    '10m_v_component_of_wind': 0.1,
    'mean_sea_level_pressure': 0.1,
    'sea_surface_temperature': 0.1,
    'total_precipitation_12hr': 0.1,
}


def rounded(value, dtype) -> float:
  """`value` rounded to `dtype`, as a Python float.

  The sampler's scalar coefficients are computed on the host in float32 and
  rounded to the sample dtype, as the reference's `.astype(x.dtype)`; a
  Python float times a tensor then rounds once, like the reference's
  same-dtype product, and needs no host-to-device copy (which would stall
  the stream between denoiser calls).
  """
  return float(torch.tensor(float(value), dtype=dtype))


class GenCast(nn.Module):
  """Denoising-diffusion predictor over packed fields.

  All tensors are [batch, lat, lon, channels] in normalized space (the
  InputsAndResiduals wrapper normalizes outside). Randomness comes from an
  explicit torch.Generator per call, or from precomputed noise fields.
  """

  def __init__(self, task: TaskSpec, statics: GraphStatics,
               transformer: TransformerConfig,
               denoiser_config: DenoiserConfig = DenoiserConfig(),
               sampler_config: SamplerConfig = SamplerConfig(),
               noise_config: NoiseConfig = NoiseConfig(), *,
               rng: torch.Generator, use_kernels: bool = True):
    super().__init__()
    self.task = task
    self.sampler_config = sampler_config
    self.noise_config = noise_config
    self.denoiser = Denoiser(task, statics, transformer, denoiser_config,
                             rng=rng, use_kernels=use_kernels)
    self.target_layout = self.denoiser.target_layout
    basis = sph_harm.basis_for_grid(statics.grid_lat, statics.grid_lon)
    self.register_buffer('sh_legendre', torch.as_tensor(basis.legendre),
                         persistent=False)
    self.register_buffer('sh_fourier', torch.as_tensor(basis.fourier),
                         persistent=False)
    chan_w, diag_w = layout_lib.loss_channel_weights(self.target_layout,
                                                     LOSS_WEIGHTS_SURFACE)
    for name, array in (
        ('lat_weights', layout_lib.latitude_weights(statics.grid_lat)),
        ('loss_weights', chan_w), ('diag_weights', diag_w)):
      self.register_buffer(name, torch.as_tensor(array), persistent=False)

  # --- EDM preconditioning (sigma_data = 1) ---

  def _precond_denoise(self, inputs, forcings, noisy_targets, sigma):
    """D(x; sigma) = c_skip x + c_out F(c_in x; sigma)."""
    s = sigma.to(noisy_targets.dtype)[:, None, None, None]
    c_in = (s ** 2 + 1.0) ** -0.5
    c_out = s * (s ** 2 + 1.0) ** -0.5
    c_skip = 1.0 / (s ** 2 + 1.0)
    raw = self.denoiser(inputs, noisy_targets * c_in, sigma, forcings)
    return raw * c_out + noisy_targets * c_skip

  def sphere_noise(self, generator: torch.Generator, batch: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Unit-variance isotropic noise, one independent field per channel:
    [B, lat, lon, C]. The one function through which sampling draws."""
    n = sph_harm.unit_white_noise(
        generator, (batch, self.target_layout.num_channels),
        self.sh_legendre, self.sh_fourier, dtype=dtype)
    return torch.movedim(n, 1, -1)

  # --- Training loss ---

  def loss(self, inputs: torch.Tensor, targets: torch.Tensor,
           forcings: torch.Tensor,
           generator: Optional[torch.Generator] = None, *,
           sigma: Optional[torch.Tensor] = None,
           noise: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-batch-element EDM loss [B], and per-variable diagnostics."""
    (loss, diagnostics), _ = self.loss_and_predictions(
        inputs, targets, forcings, generator, sigma=sigma, noise=noise)
    return loss, diagnostics

  def loss_and_predictions(self, inputs: torch.Tensor,
                           targets: torch.Tensor, forcings: torch.Tensor,
                           generator: Optional[torch.Generator] = None, *,
                           sigma: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None):
    """EDM loss and the denoised predictions from the same (single)
    denoiser call: ((loss [B], diagnostics), predictions).

    The noise level sigma [B] (float32) is drawn from the training
    distribution and the noise [B, lat, lon, C] is unit sphere noise in the
    targets' dtype, both from `generator` (sigma first), unless given.
    """
    nc = self.noise_config
    batch = targets.shape[0]
    if generator is None and (sigma is None or noise is None):
      raise ValueError('loss needs a generator, or both sigma and noise')
    if sigma is None:
      u = torch.rand((batch,), generator=generator, device=generator.device,
                     dtype=torch.float32).to(targets.device)
      sigma = diffusion_utils.rho_inverse_cdf(
          nc.training_min_noise_level, nc.training_max_noise_level,
          nc.training_noise_level_rho, u)
    sigma = sigma.to(targets.device, torch.float32)
    if noise is None:
      noise = self.sphere_noise(generator, batch, targets.dtype)
    noise = noise.to(targets.device, targets.dtype)
    noisy = targets + noise * sigma.to(targets.dtype)[:, None, None, None]
    denoised = self._precond_denoise(inputs, forcings, noisy, sigma)

    # lambda(sigma) = c_out^-2.
    lam = (sigma ** 2 + 1.0) / sigma ** 2
    loss = losses.weighted_mse(denoised, targets, self.lat_weights,
                               self.loss_weights, per_sample_scale=lam)
    diagnostics = losses.per_variable_diagnostics(
        denoised, targets, self.lat_weights, self.target_layout,
        self.diag_weights)
    return (loss, diagnostics), denoised

  def forward(self, inputs, noisy_targets, noise_levels, forcings):
    """Single preconditioned denoiser application."""
    return self._precond_denoise(inputs, forcings, noisy_targets,
                                 noise_levels)

  # --- Sampling: DPM-Solver++ 2S ---

  @torch.no_grad()
  def sample(self, inputs: torch.Tensor, forcings: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             dtype=torch.float32,
             noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Draws one sample of the (normalized-space) targets: [B, lat, lon, C].

    Noise comes from `generator`, or, when `noise` is given, from its N + 1
    precomputed unit fields [B, lat, lon, C]: the initial state's, then one
    per churn step (N steps; drawn, as in the reference, even where the
    churn rate is 0). Each field is cast to `dtype` before use.
    """
    sc = self.sampler_config
    batch = inputs.shape[0]
    sigmas = diffusion_utils.noise_schedule(
        sc.max_noise_level, sc.min_noise_level, sc.num_noise_levels, sc.rho)
    churns = diffusion_utils.stochastic_churn_rate_schedule(
        sigmas, sc.stochastic_churn_rate, sc.churn_min_noise_level,
        sc.churn_max_noise_level)
    use_churn = bool(np.any(churns > 0))
    # Schedules as float32 scalars, the dtype the reference computes in.
    sigmas = [np.float32(s) for s in sigmas]
    churns = [np.float32(c) for c in churns]
    num_steps = sc.num_noise_levels
    if noise is not None and len(noise) != num_steps + 1:
      raise ValueError(f'expected {num_steps + 1} noise fields, got '
                       f'{len(noise)}')
    if noise is None and generator is None:
      raise ValueError('sample needs a generator or precomputed noise')

    def draw(i):
      if noise is not None:
        return noise[i].to(inputs.device, dtype)
      return self.sphere_noise(generator, batch, dtype)

    def denoise(x, sigma):
      sigma_b = torch.full((batch,), max(float(sigma), 1e-6),
                           dtype=torch.float32, device=x.device)
      return self._precond_denoise(inputs, forcings, x, sigma_b)

    def churn(x, sigma, churn_rate, i):
      if not use_churn:
        return x, sigma
      # Re-inject noise: sigma -> sigma * (1 + gamma), inflated.
      new_sigma = np.float32(sigma * (np.float32(1.0) + churn_rate))
      extra_std = np.float32(
          np.sqrt(np.maximum(new_sigma ** 2 - sigma ** 2, np.float32(0.0)))
          * np.float32(sc.noise_level_inflation_factor))
      return x + draw(i) * rounded(extra_std, x.dtype), new_sigma

    x = draw(0)
    x = x * rounded(sigmas[0], x.dtype)
    for i in range(num_steps - 1):
      sigma, sigma_next = sigmas[i], sigmas[i + 1]
      x, sigma = churn(x, sigma, churns[i], i + 1)
      sigma_mid = np.float32(np.sqrt(sigma * sigma_next))
      x_denoised = denoise(x, sigma)
      alpha_mid = rounded(sigma_mid / sigma, x.dtype)
      x_mid = (alpha_mid * x
               + rounded(1.0 - alpha_mid, x.dtype) * x_denoised)
      x_mid_denoised = denoise(x_mid, sigma_mid)
      alpha_next = rounded(np.float32(sigma_next / sigma), x.dtype)
      x = (alpha_next * x
           + rounded(1.0 - alpha_next, x.dtype) * x_mid_denoised)
    # The final level (sigma_next == 0) is a single Euler step to the
    # denoised state: one call instead of two.
    x, sigma_last = churn(x, sigmas[-2], churns[-1], num_steps)
    return denoise(x, sigma_last)
