"""Plain GenCast in float32: the denoiser, its EDM preconditioning, the
DPM-Solver++ 2S sampler with stochastic churn, the isotropic noise on the
sphere, the training loss and AdamW.

Written from the published model (Price et al., "Probabilistic weather
forecasting with machine learning", Nature 2024, and DeepMind's gencast
package): a grid-to-mesh GNN, a sparse transformer over the icosahedral
mesh whose attention sees each node's k-hop neighbourhood, a mesh-to-grid
GNN, every MLP followed by a LayerNorm whose scale and offset come from the
noise level (FiLM). It runs one member at a time, on [rows, channels]
tensors, with plain torch operations only: no kernel, no graph capture, no
plan, no cache. Weights arrive as a dict under the names of the program's
parameters, which the benchmark makes and hands to both sides.

`Precision('fp8')` is the control: every matrix product reads its operands
and the sampler keeps its state rounded to float8 e4m3 (scaled per tensor),
the step below the bfloat16 that the configuration states.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import graph as graph_lib
from perfbench.reference import layout as layout_lib

Weights = Dict[str, torch.Tensor]
_ARCH = 'denoiser.architecture.'
# Rows of edges or grid nodes per piece, and query rows per attention
# block: what bounds the float32 working set.
EDGE_CHUNK = 1 << 17
QUERY_BLOCK = 1024


class Precision:
  """'f32': nothing rounded. 'fp8': operands of products and the sampler's
  state rounded to float8 e4m3 with a scale per tensor (amax to 448); the
  gradient passes straight through the rounding."""

  def __init__(self, kind: str = 'f32'):
    if kind not in ('f32', 'fp8'):
      raise ValueError(f'unknown precision {kind!r}')
    self.kind = kind

  def __call__(self, x: torch.Tensor) -> torch.Tensor:
    if self.kind == 'f32':
      return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def keyed_generator(seed: int, *keys: int, device) -> torch.Generator:
  """The generator of (seed, *keys): its stream depends on them alone."""
  words = np.random.SeedSequence([seed, *keys]).generate_state(2, np.uint32)
  value = (int(words[0]) << 32 | int(words[1])) & ((1 << 63) - 1)
  return torch.Generator(device=device).manual_seed(value)


def rho_inverse_cdf(lo: float, hi: float, rho: float, u):
  return (lo ** (1 / rho) + u * (hi ** (1 / rho) - lo ** (1 / rho))) ** rho


# --- Isotropic noise on the sphere ---

def legendre_table(x: torch.Tensor, max_l: int) -> torch.Tensor:
  """[L+1, L+1, len(x)] float64: sqrt(2 - delta_m0) N_lm P_l^m(x), with the
  Condon-Shortley phase, by the stable normalized recursions."""
  x = x.double()
  s = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
  p = torch.zeros((max_l + 1, max_l + 1, x.shape[0]), dtype=torch.float64,
                  device=x.device)
  p[0, 0] = 1.0 / math.sqrt(4.0 * math.pi)
  for m in range(1, max_l + 1):
    p[m, m] = -math.sqrt((2 * m + 1) / (2.0 * m)) * s * p[m - 1, m - 1]
  for l in range(1, max_l + 1):
    p[l, l - 1] = x * math.sqrt(2.0 * l + 1.0) * p[l - 1, l - 1]
    if l >= 2:
      m = torch.arange(l - 1, dtype=torch.float64, device=x.device)
      a = torch.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
      b = torch.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
      p[l, :l - 1] = a[:, None] * (x[None] * p[l - 1, :l - 1]
                                   - b[:, None] * p[l - 2, :l - 1])
  p[:, 1:] *= math.sqrt(2.0)
  return p


class SphereNoise:
  """Unit-variance isotropic noise with a flat spectrum up to the grid's
  wavenumber: coefficients N(0, 4 pi / ((L+1)(2l+1))) of the real
  spherical harmonics, drawn [C, 2, L+1, L+1] from the member's generator,
  synthesized in float32."""

  def __init__(self, lat_deg: np.ndarray, lon_deg: np.ndarray, device):
    max_l = len(lon_deg) // 2 - 1
    x = torch.as_tensor(np.sin(np.deg2rad(np.asarray(lat_deg, np.float64))),
                        device=device)
    self.legendre = legendre_table(x, max_l).float()
    phi = torch.as_tensor(np.deg2rad(np.asarray(lon_deg, np.float64)),
                          device=device)
    m = torch.arange(max_l + 1, dtype=torch.float64, device=device)[:, None]
    self.fourier = torch.stack([torch.cos(m * phi), torch.sin(m * phi)]
                               ).float()
    n = max_l + 1
    l_idx = torch.arange(n, device=device)
    sigma_l = torch.sqrt(4.0 * math.pi * (1.0 / n) / (2.0 * l_idx + 1.0))
    tri = (l_idx[None, :] <= l_idx[:, None]).float()
    mask = torch.stack([tri, tri * (l_idx[None, :] > 0)])
    self.scale = (mask * sigma_l[None, :, None]).float()

  def draw(self, generator: torch.Generator, channels: int) -> torch.Tensor:
    """[lat, lon, C] float32."""
    z = torch.randn((1, channels) + tuple(self.scale.shape),
                    generator=generator, device=generator.device)
    c = (z.to(self.scale.device) * self.scale)[0]
    g = torch.einsum('cslm,lmj->csmj', c, self.legendre)
    out = torch.einsum('csmj,smi->cji', g, self.fourier)
    return out.permute(1, 2, 0).contiguous()


# --- The denoiser ---

class Denoiser:
  """F(inputs, scaled noisy targets; sigma) on one member, [lat, lon, C]."""

  def __init__(self, config: dict, graph: graph_lib.Graph, weights: Weights,
               precision: Precision, device, grad: bool = False):
    self.cfg = config
    self.w = weights
    self.q = precision
    self.grad = grad
    self.task = layout_lib.task(config)
    dev = torch.device(device)
    self.cond_perm = torch.as_tensor(self.task.cond_perm, device=dev)
    self.grid_feats = torch.as_tensor(graph.grid_features, device=dev)
    self.mesh_feats = torch.as_tensor(graph.mesh_features, device=dev)
    self.g2m = [torch.as_tensor(a, device=dev) for a in (
        graph.grid2mesh.senders, graph.grid2mesh.receivers,
        graph.grid2mesh.features)]
    self.m2g = [torch.as_tensor(a, device=dev) for a in (
        graph.mesh2grid.senders, graph.mesh2grid.receivers,
        graph.mesh2grid.features)]
    # Each block of query rows with its key range [c0, c1) (the RCM order
    # keeps the k-hop mask within a band) and its part of the mask.
    self.blocks = []
    ptr, idx = graph.mask_indptr, graph.mask_indices
    for r0 in range(0, graph.num_mesh, QUERY_BLOCK):
      r1 = min(r0 + QUERY_BLOCK, graph.num_mesh)
      cols = idx[ptr[r0]:ptr[r1]]
      c0, c1 = int(cols.min()), int(cols.max()) + 1
      rows = np.repeat(np.arange(r1 - r0), np.diff(ptr[r0:r1 + 1]))
      allowed = torch.zeros((r1 - r0, c1 - c0), dtype=torch.bool,
                            device=dev)
      allowed[torch.as_tensor(rows, device=dev),
              torch.as_tensor(cols - c0, device=dev)] = True
      self.blocks.append((r0, r1, c0, c1, allowed))
    self.num_lat, self.num_lon = len(graph.grid_lat), len(graph.grid_lon)

  # Pieces, each as GenCast defines it.
  def lin(self, x, name, bias=True):
    y = self.q(x) @ self.q(self.w[name + '.weight']).t()
    return y + self.w[name + '.bias'] if bias else y

  def mlp(self, x, prefix, act: Callable = F.silu):
    h = act(self.lin(x, prefix + '.layers.0'))
    return self.lin(h, prefix + '.layers.1')

  def film(self, x, prefix, cond):
    s, o = self.lin(cond, prefix + '.linear').chunk(2, dim=-1)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + 1e-6) * (1.0 + s) + o

  def cond_mlp(self, x, prefix, cond):
    return self.film(self.mlp(x, prefix + '.network'), prefix + '.film', cond)

  def _maybe_checkpoint(self, fn, *args):
    if self.grad:
      return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)

  def _rows(self, fn, x, *rest):
    """fn over pieces of EDGE_CHUNK rows of x (rest broadcast)."""
    return torch.cat([self._maybe_checkpoint(fn, x[i:i + EDGE_CHUNK], *rest)
                      for i in range(0, x.shape[0], EDGE_CHUNK)])

  def _messages(self, edges, prefix, step, senders_lat, receivers_lat,
                num_receivers, cond):
    """The receivers' sums of the edge MLP's output over each edge set:
    the edge embedded, then updated from [edge, sender, receiver]."""
    s_all, r_all, f_all = edges
    out = torch.zeros((num_receivers, senders_lat.shape[1]),
                      dtype=torch.float32, device=senders_lat.device)

    def piece(feats, s, r, send, recv, c):
      e = self.cond_mlp(feats, f'{prefix}.edge_embedders.{step}', c)
      return self.cond_mlp(torch.cat([e, send[s], recv[r]], dim=-1),
                           f'{prefix}.processors.0.edge_mlps.{step}', c)

    for i in range(0, s_all.shape[0], EDGE_CHUNK):
      sl = slice(i, i + EDGE_CHUNK)
      upd = self._maybe_checkpoint(piece, f_all[sl], s_all[sl], r_all[sl],
                                   senders_lat, receivers_lat, cond)
      out = out.index_add(0, r_all[sl], upd)
    return out

  def attention(self, x, prefix):
    h = self.cfg['num_heads']
    d = x.shape[1] // h
    q = self.lin(x, prefix + '.q', bias=False).view(-1, h, d)
    k = self.lin(x, prefix + '.k', bias=False).view(-1, h, d)
    v = self.lin(x, prefix + '.v', bias=False).view(-1, h, d)
    outs = []
    for r0, r1, c0, c1, allowed in self.blocks:
      logits = torch.einsum('qhd,khd->hqk', self.q(q[r0:r1]),
                            self.q(k[c0:c1])) * d ** -0.5
      p = torch.softmax(logits.masked_fill(~allowed, -math.inf), dim=-1)
      outs.append(torch.einsum('hqk,khd->qhd', self.q(p), self.q(v[c0:c1])))
    o = torch.cat(outs).reshape(x.shape[0], h * d)
    return self.lin(o, prefix + '.out')

  def block(self, x, i, cond):
    p = f'{_ARCH}processor.blocks.{i}'
    x = x + self.attention(self.film(x, p + '.film1', cond), p + '.attn.proj')
    h = self.film(x, p + '.film2', cond)
    return x + self.lin(F.gelu(self.lin(h, p + '.ffw.lin1'),
                                approximate='tanh'), p + '.ffw.lin2')

  def noise_encoder(self, sigma: torch.Tensor) -> torch.Tensor:
    """[1] noise level -> [1, 16] conditioning."""
    freqs = torch.arange(1, 33, dtype=torch.float64,
                         device=sigma.device) / 16.0
    phases = torch.log(sigma)[:, None] * (2 * math.pi * freqs).float()
    h = torch.cat([torch.cos(phases), torch.sin(phases)], dim=-1)
    h = F.gelu(self.lin(h, 'denoiser.noise_encoder.linears.0'),
               approximate='tanh')
    return self.lin(h, 'denoiser.noise_encoder.linears.1')

  def __call__(self, inputs, scaled_noisy, forcings, sigma) -> torch.Tensor:
    """inputs [lat, lon, C_in], scaled noisy targets [lat, lon, C_t] and
    forcings [lat, lon, C_f] (normalized); sigma [1]."""
    cond = self.noise_encoder(sigma)
    g = self.num_lat * self.num_lon
    data = torch.cat([inputs, torch.cat([forcings, scaled_noisy], dim=-1)
                      .index_select(-1, self.cond_perm)], dim=-1)
    grid_in = torch.cat([self.grid_feats, data.reshape(g, -1)], dim=-1)
    e = f'{_ARCH}grid2mesh'
    grid = self._rows(lambda x, c: self.cond_mlp(
        x, f'{e}.node_embedders.grid', c), grid_in, cond)
    mesh = self.cond_mlp(self.mesh_feats, f'{e}.node_embedders.mesh', cond)
    agg = self._messages(self.g2m, e, 'g2m', grid, mesh, mesh.shape[0], cond)
    grid = grid + self._rows(lambda x, c: self.cond_mlp(
        x, f'{e}.processors.0.node_mlps.grid', c), grid, cond)
    mesh = mesh + self.cond_mlp(torch.cat([mesh, agg], dim=-1),
                                f'{e}.processors.0.node_mlps.mesh', cond)
    for i in range(self.cfg['num_layers']):
      mesh = self._maybe_checkpoint(self.block, mesh, i, cond)
    mesh = self.film(mesh, f'{_ARCH}processor.final_film', cond)
    dcd = f'{_ARCH}mesh2grid'
    agg = self._messages(self.m2g, dcd, 'm2g', mesh, grid, g, cond)

    def decode(x, a, c):
      x = x + self.cond_mlp(torch.cat([x, a], dim=-1),
                            f'{dcd}.processors.0.node_mlps.grid', c)
      return self.mlp(x, f'{dcd}.node_decoders.grid')

    out = torch.cat([self._maybe_checkpoint(
        decode, grid[i:i + EDGE_CHUNK], agg[i:i + EDGE_CHUNK], cond)
        for i in range(0, g, EDGE_CHUNK)])
    return out.reshape(self.num_lat, self.num_lon, -1)

  def denoise(self, inputs, noisy, forcings, sigma: float) -> torch.Tensor:
    """D(x; sigma) = c_skip x + c_out F(c_in x; sigma), sigma_data 1."""
    s = torch.full((1,), sigma, dtype=torch.float32, device=noisy.device)
    c_in = (s * s + 1.0) ** -0.5
    c_out = s * (s * s + 1.0) ** -0.5
    c_skip = 1.0 / (s * s + 1.0)
    raw = self(inputs, noisy * c_in, forcings, s)
    return raw * c_out + noisy * c_skip


# --- Wrappers: normalization, residuals, the SST fill ---

class Wrapped:
  """Raw fields in and out: inputs and forcings normalized, SST's missing
  values (land) filled with 0 in normalized space, targets predicted as
  normalized residuals from the last input frame where they are inputs."""

  def __init__(self, config: dict, graph: graph_lib.Graph, weights: Weights,
               stats: dict, precision: Precision, device, grad: bool = False):
    self.cfg = config
    self.net = Denoiser(config, graph, weights, precision, device, grad)
    t = self.net.task
    n = layout_lib.normalization(t, stats)
    dev = torch.device(device)
    self.norm = {k: torch.as_tensor(getattr(n, k), device=dev) for k in (
        'in_loc', 'in_scale', 'frc_loc', 'frc_scale', 'tgt_loc',
        'tgt_scale')}
    self.res_from = torch.as_tensor(np.maximum(n.residual_from, 0),
                                    device=dev)
    self.has_res = torch.as_tensor(n.residual_from >= 0, device=dev)
    fill = config.get('fill_nans_of')

    def chans(lay):
      m = np.zeros(lay.num_channels, dtype=bool)
      if fill in lay.names:
        m[lay.channels(fill)] = True
      return torch.as_tensor(m, device=dev)
    self.fill_in, self.fill_tgt = chans(t.inputs), chans(t.targets)
    self.lat_weights = torch.as_tensor(
        layout_lib.latitude_weights(graph.grid_lat), device=dev)
    self.loss_weights = torch.as_tensor(layout_lib.loss_weights(t.targets),
                                        device=dev)
    self.num_targets = t.targets.num_channels

  @staticmethod
  def _fill(x, mask):
    return torch.where(mask & torch.isnan(x), torch.zeros_like(x), x)

  def normalize(self, inputs, forcings):
    n = self.norm
    i = self._fill((inputs - n['in_loc']) / n['in_scale'], self.fill_in)
    return i, (forcings - n['frc_loc']) / n['frc_scale']

  def base(self, inputs):
    b = inputs.index_select(-1, self.res_from)
    return torch.where(self.has_res, b, torch.zeros_like(b))

  def normalize_targets(self, inputs, targets):
    n = self.norm
    t = (targets - self.base(inputs) - n['tgt_loc']) / n['tgt_scale']
    return self._fill(t, self.fill_tgt)

  def unnormalize(self, inputs, preds):
    return preds * self.norm['tgt_scale'] + self.norm['tgt_loc'] + \
        self.base(inputs)

  def normalized_prediction(self, inputs, raw):
    """Raw targets back in the sampler's space (normalized residuals)."""
    return ((raw - self.base(inputs) - self.norm['tgt_loc'])
            / self.norm['tgt_scale'])


# --- Sampling ---

def sampler_schedule(config: dict):
  """(sigmas with a trailing 0, churn rate per level) as float32."""
  s = config['sampler']
  levels = rho_inverse_cdf(s['min_noise_level'], s['max_noise_level'],
                           s['rho'], np.linspace(1.0, 0.0,
                                                 s['num_noise_levels']))
  sigmas = np.append(levels, 0.0)
  n = len(sigmas) - 1
  per_step = min(s['stochastic_churn_rate'] / n, np.sqrt(2.0) - 1.0)
  top = s['churn_max_noise_level']
  active = ((s['churn_min_noise_level'] <= sigmas[:-1])
            & (sigmas[:-1] <= (math.inf if top is None else top)))
  return ([np.float32(v) for v in sigmas],
          [np.float32(v) for v in active * per_step])


@torch.no_grad()
def sample_member(model: Wrapped, noise: SphereNoise, inputs, forcings,
                  generator: torch.Generator) -> torch.Tensor:
  """One member's forecast step from raw inputs [lat, lon, C_in] and the
  step's forcings [lat, lon, C_f]: the DPM-Solver++ 2S sampler over the
  noise levels, churning noise back in before each level (one draw per
  level, churned or not, from the member's generator), a single Euler
  step at the last level. Raw targets [lat, lon, C_t] out."""
  cfg = model.cfg['sampler']
  sigmas, churns = sampler_schedule(model.cfg)
  q = model.net.q
  x_in, frc = model.normalize(inputs, forcings)
  c = model.num_targets
  use_churn = any(v > 0 for v in churns)

  def denoise(x, sigma):
    return model.net.denoise(x_in, x, frc, max(float(sigma), 1e-6))

  def churn(x, sigma, rate):
    if not use_churn:
      return x, sigma
    new = np.float32(sigma * (np.float32(1.0) + rate))
    extra = np.float32(np.sqrt(np.maximum(new ** 2 - sigma ** 2,
                                          np.float32(0.0)))
                       * np.float32(cfg['noise_level_inflation_factor']))
    return q(x + noise.draw(generator, c) * float(extra)), new

  x = q(noise.draw(generator, c) * float(sigmas[0]))
  n = len(sigmas) - 1
  for i in range(n - 1):
    x, sigma = churn(x, sigmas[i], churns[i])
    nxt = sigmas[i + 1]
    mid = np.float32(np.sqrt(sigma * nxt))
    a_mid = float(mid / sigma)
    x_mid = q(a_mid * x + (1.0 - a_mid) * denoise(x, sigma))
    a_next = float(np.float32(nxt / sigma))
    x = q(a_next * x + (1.0 - a_next) * denoise(x_mid, mid))
  x, last = churn(x, sigmas[-2], churns[-1])
  return model.unnormalize(inputs, denoise(x, last))


# --- Training ---

def training_draws(generator: torch.Generator, noise: SphereNoise,
                   channels: int, config: dict):
  """The noise level (from the rho distribution) and the unit noise of one
  training step, drawn in that order."""
  t = config['training_noise']
  u = torch.rand((1,), generator=generator, device=generator.device)
  sigma = rho_inverse_cdf(t['min_noise_level'], t['max_noise_level'],
                          t['rho'], u.float())
  return sigma, noise.draw(generator, channels)


def loss(model: Wrapped, inputs, targets, forcings, sigma: torch.Tensor,
         unit_noise: torch.Tensor) -> torch.Tensor:
  """EDM loss of one example: lambda(sigma) times the latitude- and
  level-weighted squared error of D(targets + sigma noise; sigma)."""
  x_in, frc = model.normalize(inputs, forcings)
  tgt = model.normalize_targets(inputs, targets)
  s = float(sigma)
  noisy = tgt + unit_noise * s
  denoised = model.net.denoise(x_in, noisy, frc, s)
  err = (denoised - tgt) ** 2 * model.lat_weights[:, None, None]
  per_chan = err.mean(dim=(0, 1))
  return (per_chan @ model.loss_weights) * ((s * s + 1.0) / (s * s))


def warmup_cosine(config: dict) -> Callable[[int], float]:
  """Linear warm-up to the peak rate, then cosine decay to the end."""
  o = config
  warmup = min(o['warmup_steps'], max(1, o['total_steps'] // 10))
  decay = o['total_steps'] - warmup

  def rate(step: int) -> float:
    if step < warmup:
      return o['learning_rate'] * step / warmup
    k = min(step - warmup, decay)
    return o['learning_rate'] * 0.5 * (1 + math.cos(math.pi * k / decay))
  return rate


class AdamW:
  """Global-norm clipping, then AdamW with decoupled weight decay on every
  parameter (a parameter that the loss does not reach has a zero
  gradient)."""

  def __init__(self, params: Dict[str, torch.Tensor], config: dict):
    self.p = params
    self.cfg = config
    self.rate = warmup_cosine(config)
    self.m = {k: torch.zeros_like(v) for k, v in params.items()}
    self.v = {k: torch.zeros_like(v) for k, v in params.items()}
    self.t = 0

  def step(self, grads: Dict[str, Optional[torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    """Takes one step; returns the clipped gradients."""
    c = self.cfg
    g = {k: (grads[k] if grads.get(k) is not None
             else torch.zeros_like(self.p[k])) for k in self.p}
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x) for x in g.values()]))
    factor = 1.0 if float(norm) < c['clip_norm'] else c['clip_norm'] / float(
        norm)
    g = {k: x * factor for k, x in g.items()}
    lr = self.rate(self.t)
    self.t += 1
    b1, b2 = c['b1'], c['b2']
    bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
    with torch.no_grad():
      for k, p in self.p.items():
        p.mul_(1 - lr * c['weight_decay'])
        self.m[k].mul_(b1).add_(g[k], alpha=1 - b1)
        self.v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
        denom = self.v[k].sqrt() / math.sqrt(bc2) + c['eps']
        p.addcdiv_(self.m[k], denom, value=-lr / bc1)
    return g


def parameters(weights: Weights, names: Sequence[str], device
               ) -> Dict[str, torch.Tensor]:
  """Float32 leaves on `device`, copies of `weights`, that take gradients."""
  return {n: weights[n].detach().to(device, torch.float32).clone()
          .requires_grad_(True) for n in names}


def train_steps(config: dict, graph: graph_lib.Graph, weights: Weights,
                stats: dict, examples: List[tuple], keys: List[tuple],
                precision: Precision, device) -> dict:
  """Follows len(examples) training steps from `weights`: example k =
  (inputs, targets, forcings) raw, step k's draws from the generator of
  keys[k]. Returns the losses, the first step's clipped gradients and the
  parameters after the last step."""
  params = parameters(weights, list(weights), device)
  model = Wrapped(config, graph, params, stats, precision, device, grad=True)
  noise = SphereNoise(graph.grid_lat, graph.grid_lon, device)
  opt = AdamW(params, config['optimizer'])
  losses, first = [], None
  for (inputs, targets, forcings), key in zip(examples, keys):
    gen = keyed_generator(*key, device=device)
    sigma, unit = training_draws(gen, noise, model.num_targets, config)
    value = loss(model, inputs, targets, forcings, sigma, unit)
    grads = torch.autograd.grad(value, list(params.values()),
                                allow_unused=True)
    clipped = opt.step(dict(zip(params, grads)))
    if first is None:
      first = {k: v.detach() for k, v in clipped.items()}
    losses.append(float(value.detach()))
  return {'losses': losses, 'first_grads': first,
          'params': {k: v.detach() for k, v in params.items()}}
