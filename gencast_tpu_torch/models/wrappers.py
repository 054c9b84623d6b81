"""Predictor wrappers: normalization/residuals and NaN cleaning.

Counterpart of `gencast_tpu.models.wrappers`: `__call__`, `sample`,
`predict` (GraphCast), `loss` and `loss_and_predictions`. A ChannelLayout
fixes channel <-> (variable, level, frame), so each wrapper is a handful
of precomputed per-channel vectors applied elementwise. Loss calls pass
`generator` and any keyword arguments (the injected `sigma` / `noise`)
through to GenCast; so do `sample` calls, a member batch's `generators`
or per-member `noise` too (`GenCast.sample`): the normalization, the NaN
cleaning and the residuals act row by row, so each member's rows are
treated as in its own call.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gencast_tpu_torch.data import layout as layout_lib


def find_layout_provider(model: nn.Module) -> nn.Module:
  """Walks wrapper nesting (wrappers hold .predictor, GenCast holds
  .denoiser) to the module exposing input/target/forcing layouts (the
  denoiser, or a GraphCast itself)."""
  d = model
  while not hasattr(d, 'input_layout'):
    d = d.denoiser if hasattr(d, 'denoiser') else d.predictor
  return d


class InputsAndResiduals(nn.Module):
  """Normalizes inputs/forcings; the inner predictor works on normalized
  residuals for targets that are also inputs ((target - last input frame)
  / diffs_std) and on normalized values for the others. Predictions are
  mapped back before returning."""

  def __init__(self, predictor: nn.Module, stats: layout_lib.Stats):
    super().__init__()
    self.predictor = predictor
    d = find_layout_provider(predictor)
    in_lay, tgt_lay, frc_lay = (d.input_layout, d.target_layout,
                                d.forcing_layout)

    def vec(name, x):
      self.register_buffer(name, torch.as_tensor(x), persistent=False)

    vec('in_loc', layout_lib.channel_locations(in_lay, stats))
    vec('in_scale', layout_lib.channel_scales(in_lay, stats))
    vec('frc_loc', layout_lib.channel_locations(frc_lay, stats))
    vec('frc_scale', layout_lib.channel_scales(frc_lay, stats))
    res_map = layout_lib.residual_channel_map(tgt_lay, in_lay)
    has_res = res_map >= 0
    tgt_loc = layout_lib.channel_locations(tgt_lay, stats)
    tgt_scale = layout_lib.channel_scales(tgt_lay, stats)
    diffs = layout_lib.channel_residual_scales(tgt_lay, stats)
    vec('res_map', np.maximum(res_map, 0).astype(np.int64))
    vec('has_res', has_res)
    # Residual channels: location is the last input frame, scale diffs_std.
    vec('tgt_loc', np.where(has_res, 0.0, tgt_loc).astype(np.float32))
    vec('tgt_scale', np.where(has_res, diffs, tgt_scale).astype(np.float32))

  def _norm_inputs(self, x):
    return (x - self.in_loc.to(x.dtype)) / self.in_scale.to(x.dtype)

  def _norm_forcings(self, x):
    return (x - self.frc_loc.to(x.dtype)) / self.frc_scale.to(x.dtype)

  def _residual_base(self, raw_inputs):
    """Per-target-channel base value: last input frame (or 0)."""
    base = raw_inputs.index_select(-1, self.res_map)
    return torch.where(self.has_res, base, torch.zeros_like(base))

  def _norm_targets(self, raw_inputs, targets):
    base = self._residual_base(raw_inputs)
    return ((targets - base - self.tgt_loc.to(targets.dtype))
            / self.tgt_scale.to(targets.dtype))

  def _unnorm_predictions(self, raw_inputs, preds):
    base = self._residual_base(raw_inputs).to(preds.dtype)
    return (preds * self.tgt_scale.to(preds.dtype)
            + self.tgt_loc.to(preds.dtype) + base)

  def loss(self, inputs, targets, forcings, generator=None, **kwargs):
    return self.predictor.loss(
        self._norm_inputs(inputs), self._norm_targets(inputs, targets),
        self._norm_forcings(forcings), generator, **kwargs)

  def loss_and_predictions(self, inputs, targets, forcings, generator=None,
                           **kwargs):
    (loss, diags), norm_preds = self.predictor.loss_and_predictions(
        self._norm_inputs(inputs), self._norm_targets(inputs, targets),
        self._norm_forcings(forcings), generator, **kwargs)
    return (loss, diags), self._unnorm_predictions(inputs, norm_preds)

  def forward(self, inputs, noisy_targets, noise_levels, forcings):
    preds = self.predictor(self._norm_inputs(inputs), noisy_targets,
                           noise_levels, self._norm_forcings(forcings))
    return self._unnorm_predictions(inputs, preds)

  def sample(self, inputs, forcings, generator=None, **kwargs):
    """Full diffusion sampling in normalized-residual space, mapped back."""
    norm_preds = self.predictor.sample(
        self._norm_inputs(inputs), self._norm_forcings(forcings), generator,
        **kwargs)
    return self._unnorm_predictions(inputs, norm_preds)

  def predict(self, inputs, forcings, generator=None, **kwargs):
    """The deterministic forward (GraphCast), normalized and mapped back."""
    norm_preds = self.predictor.predict(
        self._norm_inputs(inputs), self._norm_forcings(forcings), generator,
        **kwargs)
    return self._unnorm_predictions(inputs, norm_preds)


class NaNCleaner(nn.Module):
  """Replaces NaNs of one variable (e.g. sea_surface_temperature) with a
  fill value before the wrapped predictor sees the data; optionally puts
  them back into predictions using the input NaN mask."""

  def __init__(self, predictor: nn.Module, var_to_clean: str,
               fill_value: float, reintroduce_nans: bool = False):
    super().__init__()
    self.predictor = predictor
    self.reintroduce_nans = reintroduce_nans
    self.fill_value = fill_value
    d = find_layout_provider(predictor)
    for role, lay in (('inputs', d.input_layout),
                      ('targets', d.target_layout),
                      ('forcings', d.forcing_layout)):
      m = np.zeros(lay.num_channels, dtype=bool)
      if var_to_clean in lay.var_names:
        m[lay.var_channels(var_to_clean)] = True
      self.register_buffer(f'mask_{role}', torch.as_tensor(m),
                           persistent=False)
    tgt = d.target_layout
    self._has_target_var = var_to_clean in tgt.var_names
    if self._has_target_var:
      self.register_buffer(
          'tgt_chans', torch.as_tensor(tgt.var_channels(var_to_clean)),
          persistent=False)
      self.register_buffer(
          'in_chans',
          torch.as_tensor(d.input_layout.var_channels(var_to_clean)),
          persistent=False)

  def _clean(self, x, role):
    mask = getattr(self, f'mask_{role}') & torch.isnan(x)
    return torch.where(mask, torch.full_like(x, self.fill_value), x)

  def _reintroduce(self, raw_inputs, preds):
    if not (self.reintroduce_nans and self._has_target_var):
      return preds
    nan_any = torch.isnan(raw_inputs.index_select(-1, self.in_chans)).any(
        dim=-1, keepdim=True)
    chan_is_var = torch.zeros(preds.shape[-1], dtype=torch.bool,
                              device=preds.device)
    chan_is_var[self.tgt_chans] = True
    return torch.where(chan_is_var & nan_any,
                       torch.full_like(preds, float('nan')), preds)

  def loss(self, inputs, targets, forcings, generator=None, **kwargs):
    return self.predictor.loss(
        self._clean(inputs, 'inputs'), self._clean(targets, 'targets'),
        self._clean(forcings, 'forcings'), generator, **kwargs)

  def loss_and_predictions(self, inputs, targets, forcings, generator=None,
                           **kwargs):
    (loss, diags), preds = self.predictor.loss_and_predictions(
        self._clean(inputs, 'inputs'), self._clean(targets, 'targets'),
        self._clean(forcings, 'forcings'), generator, **kwargs)
    return (loss, diags), self._reintroduce(inputs, preds)

  def forward(self, inputs, noisy_targets, noise_levels, forcings):
    preds = self.predictor(self._clean(inputs, 'inputs'), noisy_targets,
                           noise_levels, self._clean(forcings, 'forcings'))
    return self._reintroduce(inputs, preds)

  def sample(self, inputs, forcings, generator=None, **kwargs):
    preds = self.predictor.sample(self._clean(inputs, 'inputs'),
                                  self._clean(forcings, 'forcings'),
                                  generator, **kwargs)
    return self._reintroduce(inputs, preds)

  def predict(self, inputs, forcings, generator=None, **kwargs):
    preds = self.predictor.predict(self._clean(inputs, 'inputs'),
                                   self._clean(forcings, 'forcings'),
                                   generator, **kwargs)
    return self._reintroduce(inputs, preds)


def build_stack(model: nn.Module, stats: layout_lib.Stats, *, bf16: bool,
                clean_sst_nans: bool = False,
                normalize: bool = True) -> nn.Module:
  """Assembles the production wrapper stack, in the reference's order:
  Bfloat16Cast (innermost) -> NaNCleaner -> InputsAndResiduals.

  NaNCleaner sits inside InputsAndResiduals and so sees normalized data:
  its fill is 0.0 (the raw-space mean); only with normalize=False does the
  raw mean apply. With bf16, build the stack after the model's weights are
  loaded (or call the Bfloat16Cast's refresh() after a later load).
  """
  task = model.task
  wrapped = model
  if bf16:
    from gencast_tpu_torch.models import casting
    wrapped = casting.Bfloat16Cast(wrapped)
  if clean_sst_nans and 'sea_surface_temperature' in task.input_variables:
    fill = (0.0 if normalize
            else float(np.asarray(stats.mean['sea_surface_temperature'])))
    wrapped = NaNCleaner(wrapped, 'sea_surface_temperature', fill)
  if normalize:
    wrapped = InputsAndResiduals(wrapped, stats)
  return wrapped
