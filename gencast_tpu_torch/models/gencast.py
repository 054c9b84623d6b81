"""GenCast: EDM-preconditioned diffusion forecasting and its sampler.

Counterpart of `gencast_tpu.models.gencast`: the preconditioned denoiser,
its EDM training loss, and the DPM-Solver++ 2S sampler with stochastic
churn. A forecast step makes 2N - 1 denoiser calls: a 2S step (two calls)
for each of the first N - 1 noise levels, then a single Euler step at the
last level. The loss makes one denoiser call, as the reference.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch import utils
from gencast_tpu_torch.data import layout as layout_lib
from gencast_tpu_torch.data.registry import TaskSpec
from gencast_tpu_torch.graph.compiler import GraphStatics
from gencast_tpu_torch.models import diffusion_utils
from gencast_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from gencast_tpu_torch.nn.transformer import TransformerConfig
from gencast_tpu_torch.ops import cuda_lib, losses, sph_harm
from gencast_tpu_torch.parallel import tensor


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


def member_draws(generator, generators, noise, depth: int):
  """A sampler's draws as a list per member: (generators, noise, one).

  Exactly one source is given: `generator` (one member's), `generators`
  (one per member) or `noise`, which is either one member's fields, nested
  `depth` lists deep down to the tensors (GenCast.sample: 1, its N + 1
  fields; rollout.sample_rollout: 2, those of each step), or a list of
  such, one per member. `one` is True where one member's draws were given,
  so the caller returns its result without the member axis."""
  if (generator is not None) + (generators is not None) + (
      noise is not None) != 1:
    raise ValueError('sampling needs a generator or per-step noise, or '
                     'generators (one per member): exactly one of them')
  if generator is not None:
    if not isinstance(generator, torch.Generator):
      raise TypeError(f'generator is one torch.Generator, not '
                      f'{type(generator).__name__}: give a member batch\'s '
                      'as generators=')
    return [generator], None, True
  if generators is not None:
    if not generators:
      raise ValueError('no members: generators is empty')
    return list(generators), None, False
  nested, x = 0, noise
  while isinstance(x, (list, tuple)) and x:
    nested, x = nested + 1, x[0]
  one = nested <= depth
  return None, [noise] if one else list(noise), one


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
               rng: torch.Generator, use_kernels: bool = True,
               noise_basis_dtype: torch.dtype = torch.float32,
               basis_device: torch.device | str = 'cpu',
               dense_attention_mask: Optional[np.ndarray] = None):
    super().__init__()
    self.task = task
    self.sampler_config = sampler_config
    self.noise_config = noise_config
    self.denoiser = Denoiser(task, statics, transformer, denoiser_config,
                             rng=rng, use_kernels=use_kernels,
                             dense_attention_mask=dense_attention_mask)
    self.target_layout = self.denoiser.target_layout
    # The noise basis in its storage dtype (the reference's
    # noise_basis_dtype), made on `basis_device`: a bf16 0.25-degree table
    # is computed there (ops/sph_harm.py).
    basis = sph_harm.basis_for_grid(statics.grid_lat, statics.grid_lon,
                                    dtype=noise_basis_dtype,
                                    device=basis_device)
    self.register_buffer('sh_legendre', basis.legendre, persistent=False)
    self.register_buffer('sh_fourier', basis.fourier, persistent=False)
    # The sampler's graphs of a denoiser call, one per shapes and dtype.
    self.denoiser_graphs = cuda_lib.GraphedCalls()
    chan_w, diag_w = layout_lib.loss_channel_weights(self.target_layout,
                                                     LOSS_WEIGHTS_SURFACE)
    for name, array in (
        ('lat_weights', layout_lib.latitude_weights(statics.grid_lat)),
        ('loss_weights', chan_w), ('diag_weights', diag_w)):
      self.register_buffer(name, torch.as_tensor(array), persistent=False)

  def _apply(self, fn, recurse=True):
    # Moving the parameters (.to(), .cuda()) gives them new storage, which
    # the sampler's graphs would not see.
    self.denoiser_graphs = cuda_lib.GraphedCalls()
    return super()._apply(fn, recurse)

  # --- EDM preconditioning (sigma_data = 1) ---

  def _precond_denoise(self, inputs, forcings, noisy_targets, sigma):
    """D(x; sigma) = c_skip x + c_out F(c_in x; sigma)."""
    with utils.span('denoiser', noisy_targets.device):
      s = sigma.to(noisy_targets.dtype)[:, None, None, None]
      c_in = (s ** 2 + 1.0) ** -0.5
      c_out = s * (s ** 2 + 1.0) ** -0.5
      c_skip = 1.0 / (s ** 2 + 1.0)
      raw = self.denoiser(inputs, noisy_targets * c_in, sigma, forcings)
      out = raw * c_out + noisy_targets * c_skip
    return utils.gradient_mark('denoiser', out)

  def sphere_noise(self, generator: torch.Generator, batch: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Unit-variance isotropic noise, one independent field per channel:
    [B, lat, lon, C]. The one function through which sampling draws."""
    with utils.span('noise', self.sh_legendre.device):
      n = sph_harm.unit_white_noise(
          generator, (batch, self.target_layout.num_channels),
          self.sh_legendre, self.sh_fourier, dtype=dtype)
      return torch.movedim(n, 1, -1)

  # --- Training loss ---

  def training_draws(self, generator: torch.Generator, batch: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training loss's random draws, from `generator` in this order:
    the noise level sigma [B] (float32) from the training distribution,
    then unit sphere noise [B, lat, lon, C] (float32), both on the model's
    device. The loss draws through this function, and the graphed training
    step (`training.steps.scanned_train_steps`) calls it outside its graph,
    so both draw the same bits from a step's generator."""
    nc = self.noise_config
    u = torch.rand((batch,), generator=generator, device=generator.device,
                   dtype=torch.float32).to(self.sh_legendre.device)
    sigma = diffusion_utils.rho_inverse_cdf(
        nc.training_min_noise_level, nc.training_max_noise_level,
        nc.training_noise_level_rho, u)
    return sigma, self.sphere_noise(generator, batch)

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

    The noise level sigma [B] and the unit sphere noise [B, lat, lon, C]
    come from `training_draws(generator)`, or are both given; the noise is
    rounded to the targets' dtype.
    """
    batch = targets.shape[0]
    if sigma is None and noise is None:
      if generator is None:
        raise ValueError('loss needs a generator, or both sigma and noise')
      sigma, noise = self.training_draws(generator, batch)
    elif sigma is None or noise is None:
      raise ValueError('loss takes both sigma and noise, or neither')
    sigma = sigma.to(targets.device, torch.float32)
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
             noise: Optional[Sequence] = None,
             graphed: bool = True,
             generators: Optional[Sequence[torch.Generator]] = None
             ) -> torch.Tensor:
    """Draws one sample of the (normalized-space) targets: [B, lat, lon, C].

    Noise comes from `generator`, or, when `noise` is given, from its N + 1
    precomputed unit fields [B, lat, lon, C]: the initial state's, then one
    per churn step (N steps; drawn, as in the reference, even where the
    churn rate is 0). Each field is cast to `dtype` before use.

    A member batch (the reference's vmap over member keys): the inputs'
    M·B rows are M members of B rows each, member after member, and the
    draws come from `generators` (one per member) or from `noise` given
    per member (M lists of N + 1 fields [B, lat, lon, C]); one generator
    or one list of fields is the batch of one member (`member_draws`).
    Field i of member m is drawn as that member's own call draws it,
    `sphere_noise(generators[m], B, dtype)`, level by level, and the
    members' fields are concatenated on the batch axis: member m's rows
    see bitwise the draws of its one-member call.

    On the card each denoiser call replays one CUDA graph of it (the port's
    counterpart of the reference's jitted sampler scan), captured at this
    model's first call of these shapes; the draws and the few elementwise
    ops between calls stay eager. `graphed=False` runs every call eagerly.
    On the CPU, and for a model sharded over a model axis (its
    all_reduces are not captured, parallel/tensor.py), the calls run
    eagerly either way.
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
    generators, noise, _ = member_draws(generator, generators, noise, 1)
    members = len(generators or noise)
    if batch % members:
      raise ValueError(f'{members} members for a batch of {batch} rows')
    for fields in noise or []:
      if len(fields) != num_steps + 1:
        raise ValueError(f'expected {num_steps + 1} noise fields, got '
                         f'{len(fields)}')

    def draw(i):
      if generators is not None:
        return torch.cat([self.sphere_noise(g, batch // members, dtype)
                          for g in generators])
      return torch.cat([fields[i].to(inputs.device, dtype)
                        for fields in noise])

    # On the card each denoiser call replays one graph over static buffers:
    # the window (loaded once per sample), the state x and the [B] noise
    # level (loaded before each call).
    graph = None
    if graphed and inputs.is_cuda and not tensor.is_sharded(self):
      x_shape = inputs.shape[:-1] + (self.target_layout.num_channels,)
      graph = self.denoiser_graphs.get(
          cuda_lib.signature(inputs, forcings) + (x_shape, dtype),
          lambda: (torch.empty_like(inputs), torch.empty_like(forcings),
                   inputs.new_empty(x_shape, dtype=dtype),
                   inputs.new_empty(batch, dtype=torch.float32)))
      graph.load(inputs, forcings)

    calls = itertools.count()

    def denoise(x, sigma):
      level = max(float(sigma), 1e-6)
      k = next(calls)  # calls 2i and 2i + 1 at noise level i; the last alone
      with utils.span('sample.call', unit=f'level={k // 2} call={k}'):
        if graph is not None:
          graph.load(x, level, first=2)
          return graph(self._precond_denoise)
        sigma_b = torch.full((batch,), level, dtype=torch.float32,
                             device=x.device)
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
    out = denoise(x, sigma_last)
    # A replay's output is the graph's buffer, which the next call rewrites.
    return out if graph is None else out.clone()
