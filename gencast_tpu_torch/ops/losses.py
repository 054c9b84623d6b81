"""Packed-array loss functions.

Counterpart of `gencast_tpu.ops.losses`: the latitude- and
pressure-weighted MSE of the reference as one reduction over a packed
[batch, lat, lon, C] tensor with per-channel weight vectors from
`data.layout.loss_channel_weights`. Dtypes follow the reference: the error
is taken in the predictions' dtype and the weights are cast to it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gencast_tpu_torch.data import layout as layout_lib


def _weighted_error(predictions: torch.Tensor, targets: torch.Tensor,
                    lat_weights: torch.Tensor) -> torch.Tensor:
  """Squared error times latitude weights, meaned over lat/lon: [B, C]."""
  err = (predictions - targets) ** 2
  err = err * lat_weights.to(err.dtype)[None, :, None, None]
  return err.mean(dim=(1, 2))


def weighted_mse(predictions: torch.Tensor,    # [B, lat, lon, C]
                 targets: torch.Tensor,        # [B, lat, lon, C]
                 lat_weights: torch.Tensor,    # [lat]
                 channel_weights: torch.Tensor,  # [C], level/var weights
                                                 # and channel means folded
                 per_sample_scale: Optional[torch.Tensor] = None,  # [B]
                 ) -> torch.Tensor:
  """Loss per batch element, shape [B]."""
  per_chan = _weighted_error(predictions, targets, lat_weights)
  loss = per_chan @ channel_weights.to(per_chan.dtype)
  if per_sample_scale is not None:
    loss = loss * per_sample_scale.to(loss.dtype)
  return loss


def per_variable_diagnostics(predictions: torch.Tensor,
                             targets: torch.Tensor,
                             lat_weights: torch.Tensor,
                             layout: layout_lib.ChannelLayout,
                             diag_weights) -> Dict[str, torch.Tensor]:
  """Per-variable (level-weighted, unscaled) losses, each [B]. diag_weights
  [C] is a numpy array or a tensor."""
  per_chan = _weighted_error(predictions, targets, lat_weights)
  per_chan = per_chan * torch.as_tensor(diag_weights, dtype=per_chan.dtype,
                                        device=per_chan.device)
  out = {}
  for name in layout.var_names:
    # A layout keeps each variable's channels contiguous.
    chans = layout.var_channels(name)
    out[name] = per_chan[:, int(chans[0]):int(chans[-1]) + 1].sum(dim=-1)
  return out
