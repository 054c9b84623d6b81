"""Probabilistic forecast verification metrics.

Counterpart of `gencast_tpu.ops.metrics`: the fair ensemble CRPS (GenCast's
headline metric), ensemble-mean RMSE and spread, latitude-area-weighted,
on packed [members, ..., lat, lon, channels] tensors, in torch on the
tensors' device (plain arithmetic: no kernel). WeatherBench2 definitions,
as the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gencast_tpu_torch.data import layout as layout_lib


def _latw(err: torch.Tensor, lat_weights: torch.Tensor) -> torch.Tensor:
  """Applies [lat] weights to a [..., lat, lon, C] tensor."""
  return err * lat_weights.to(err.device, err.dtype)[..., :, None, None]


def _crps_pointwise(members: torch.Tensor, truth: torch.Tensor,
                    spread: str) -> torch.Tensor:
  """CRPS per grid point: E|X - y| - 1/2 E|X - X'|, unbiased M(M-1) spread.

  spread='sorted' uses sum_{i,j} |x_i - x_j| = 2 sum_k (2k - M + 1) x_(k)
  over the ascending x_(k): O(M log M) time and O(M) memory per point;
  'pairwise' is the small-M cross-check.
  """
  m = members.shape[0]
  skill = (members - truth[None]).abs().mean(dim=0)
  if m == 1:
    return skill
  if spread == 'pairwise':
    diffs = (members[:, None] - members[None, :]).abs()
    sp = diffs.sum(dim=(0, 1)) / (m * (m - 1))
  elif spread == 'sorted':
    srt = torch.sort(members, dim=0).values
    coef = 2.0 * torch.arange(m, dtype=srt.dtype, device=srt.device) - m + 1
    sp = 2.0 * torch.tensordot(coef, srt, dims=([0], [0])) / (m * (m - 1))
  else:
    raise ValueError(f'unknown spread estimator: {spread!r}')
  return skill - 0.5 * sp


def crps_ensemble(members: torch.Tensor, truth: torch.Tensor,
                  lat_weights: torch.Tensor,
                  spread: str = 'sorted') -> torch.Tensor:
  """Fair (unbiased) ensemble CRPS per channel.

  members: [M, ..., lat, lon, C]; truth: [..., lat, lon, C]. Returns
  [..., C] (the area-weighted spatial mean).
  """
  crps = _crps_pointwise(members, truth, spread)
  return _latw(crps, lat_weights).mean(dim=(-3, -2))


def _variance(members: torch.Tensor) -> torch.Tensor:
  if members.shape[0] > 1:
    return members.var(dim=0, correction=1)
  return torch.zeros_like(members[0])


def weighted_sums(members: torch.Tensor, truth: torch.Tensor,
                  lat_weights: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The latitude-weighted sums over (lat, lon) of the pointwise CRPS, the
  squared error of the ensemble mean and the ensemble variance: [..., C]
  each. Over all latitudes, divided by lat x lon, they are crps_ensemble,
  ensemble_mean_rmse ** 2 and ensemble_spread ** 2; over a band of them,
  its share."""
  w = torch.as_tensor(lat_weights)
  return (_latw(_crps_pointwise(members, truth, 'sorted'), w).sum(dim=(-3, -2)),
          _latw((members.mean(dim=0) - truth) ** 2, w).sum(dim=(-3, -2)),
          _latw(_variance(members), w).sum(dim=(-3, -2)))


def score_ensemble_chunked(members, truth, lat_weights, lat_chunk: int = 16,
                           device: Optional[torch.device] = None
                           ) -> Dict[str, np.ndarray]:
  """CRPS, ensemble-mean RMSE and spread, a band of latitudes at a time.

  members: [M, ..., lat, lon, C], truth: [..., lat, lon, C] (numpy or
  torch); each band is scored on `device` (default: members' device, the
  CPU for numpy) and its sums are added in float64 on the host, so the
  device holds O(M * lat_chunk * lon * C) whatever the ensemble. Returns
  {'crps', 'rmse', 'spread'}: [..., C] float64 numpy.
  """
  if device is None:
    device = (members.device if isinstance(members, torch.Tensor)
              else torch.device('cpu'))
  nlat, nlon = truth.shape[-3], truth.shape[-2]

  def band(x, lo, hi):
    return torch.as_tensor(x[..., lo:hi, :, :]).to(device)

  w_all = torch.as_tensor(np.asarray(lat_weights))
  sums = None
  for lo in range(0, nlat, lat_chunk):
    hi = min(lo + lat_chunk, nlat)
    out = weighted_sums(band(members, lo, hi), band(truth, lo, hi),
                        w_all[lo:hi])
    out = [o.cpu().numpy().astype(np.float64) for o in out]
    sums = out if sums is None else [a + b for a, b in zip(sums, out)]
  area = nlat * nlon
  crps, rmse_sq, spread_sq = sums
  return {'crps': crps / area,
          'rmse': np.sqrt(rmse_sq / area),
          'spread': np.sqrt(spread_sq / area)}


def ensemble_mean_rmse(members: torch.Tensor, truth: torch.Tensor,
                       lat_weights: torch.Tensor) -> torch.Tensor:
  """Area-weighted RMSE of the ensemble mean, per channel: [..., C]."""
  err = (members.mean(dim=0) - truth) ** 2
  return torch.sqrt(_latw(err, lat_weights).mean(dim=(-3, -2)))


def ensemble_spread(members: torch.Tensor,
                    lat_weights: torch.Tensor) -> torch.Tensor:
  """Area-weighted ensemble standard deviation, per channel: [..., C]."""
  return torch.sqrt(_latw(_variance(members), lat_weights).mean(dim=(-3, -2)))


def per_variable(metric_per_channel, layout: layout_lib.ChannelLayout
                 ) -> Dict[str, np.ndarray]:
  """Averages a [..., C] per-channel metric into per-variable values."""
  x = (metric_per_channel.detach().cpu().numpy()
       if isinstance(metric_per_channel, torch.Tensor)
       else np.asarray(metric_per_channel))
  return {name: x[..., layout.var_channels(name)].mean(axis=-1)
          for name in layout.var_names}
