"""ChannelLayout: static per-channel metadata for packed field tensors.

A packed tensor has shape [batch, lat, lon, channels]. Channels are ordered
by sorted variable name, time-major / level-minor within each variable, the
same order as `gencast_tpu.data.layout`, so channel indices are
interchangeable between the two packages. This module carries that file
over: layouts, merge permutations, `pack` (numpy) and `unpack` (numpy or
torch), statistics and the per-channel vectors derived from them, the
rollout's frame-advance maps, and the loss weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gencast_tpu_torch.data import registry


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelLayout:
  """Static channel metadata for one packed tensor.

  Attributes:
    var_names: unique variable names, sorted (= packing order).
    pressure_levels: the level table used for atmospheric variables.
    num_times: per-variable number of time frames (statics contribute 1).
    channel_var: [C] index into var_names.
    channel_time: [C] time-frame index within the variable.
    channel_level: [C] index into pressure_levels, or -1 for surface/static.
  """
  var_names: Tuple[str, ...]
  pressure_levels: Tuple[int, ...]
  num_times: int
  channel_var: np.ndarray
  channel_time: np.ndarray
  channel_level: np.ndarray

  def __eq__(self, other):
    return (isinstance(other, ChannelLayout)
            and self.var_names == other.var_names
            and self.pressure_levels == other.pressure_levels
            and self.num_times == other.num_times)

  def __hash__(self):
    return hash((self.var_names, self.pressure_levels, self.num_times))

  @property
  def num_channels(self) -> int:
    return self.channel_var.shape[0]

  def var_channels(self, name: str) -> np.ndarray:
    """Channel indices belonging to variable `name`."""
    v = self.var_names.index(name)
    return np.nonzero(self.channel_var == v)[0]

  def channels_per_var(self) -> Dict[str, int]:
    return {name: len(self.var_channels(name)) for name in self.var_names}


def build_layout(
    var_names: Sequence[str],
    pressure_levels: Sequence[int],
    num_times: int,
) -> ChannelLayout:
  """Layout for the given variables at `num_times` frames.

  Static variables (registry.STATIC_VARS) contribute a single channel;
  surface variables contribute num_times channels; atmospheric ones
  num_times * len(pressure_levels), level-minor.
  """
  names = tuple(sorted(set(var_names)))
  cv, ct, cl = [], [], []
  for vi, name in enumerate(names):
    times = 1 if registry.is_static(name) else num_times
    levels = (range(len(pressure_levels)) if registry.is_atmospheric(name)
              else [-1])
    for t in range(times):
      for l in levels:
        cv.append(vi)
        ct.append(t)
        cl.append(l)
  return ChannelLayout(
      var_names=names,
      pressure_levels=tuple(pressure_levels),
      num_times=num_times,
      channel_var=np.asarray(cv, dtype=np.int32),
      channel_time=np.asarray(ct, dtype=np.int32),
      channel_level=np.asarray(cl, dtype=np.int32),
  )


def pack(fields: Mapping[str, np.ndarray], layout: ChannelLayout,
         batch_size: Optional[int] = None) -> np.ndarray:
  """dict of named numpy arrays -> [batch, lat, lon, C].

  Expected shapes per variable kind:
    static:   [lat, lon]                     (broadcast over batch)
    surface:  [batch, T, lat, lon]
    atmos:    [batch, T, L, lat, lon]
  """
  parts = []
  for name in layout.var_names:
    x = np.asarray(fields[name])
    if registry.is_static(name):
      if x.ndim != 2:
        raise ValueError(f'{name}: expected [lat, lon], got {x.shape}')
      b = batch_size
      if b is None:
        b = next(np.shape(v)[0] for k, v in fields.items()
                 if not registry.is_static(k))
      x = np.broadcast_to(x[None, :, :, None], (b,) + x.shape + (1,))
    elif registry.is_atmospheric(name):
      if x.ndim != 5:
        raise ValueError(f'{name}: expected [B,T,L,lat,lon], got {x.shape}')
      t, l = x.shape[1], x.shape[2]
      x = np.moveaxis(x, (1, 2), (3, 4)).reshape(x.shape[0], x.shape[3],
                                                 x.shape[4], t * l)
    else:
      if x.ndim != 4:
        raise ValueError(f'{name}: expected [B,T,lat,lon], got {x.shape}')
      x = np.moveaxis(x, 1, 3)
    expected = len(layout.var_channels(name))
    if x.shape[-1] != expected:
      raise ValueError(
          f'{name}: packs to {x.shape[-1]} channels, layout expects '
          f'{expected} (num_times={layout.num_times}, '
          f'levels={len(layout.pressure_levels)})')
    parts.append(x)
  return np.concatenate(parts, axis=-1)


def unpack(packed: Union[np.ndarray, torch.Tensor], layout: ChannelLayout
           ) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
  """[batch, lat, lon, C] -> dict of named arrays (the inverse of `pack`).

  A numpy array stays a numpy array on the host, a torch tensor stays a
  tensor on its device. Shapes per variable kind: static [batch, lat, lon],
  surface [batch, T, lat, lon], atmospheric [batch, T, L, lat, lon].
  """
  moveaxis = np.moveaxis if isinstance(packed, np.ndarray) else torch.movedim
  out = {}
  idx = 0
  nl = len(layout.pressure_levels)
  for name in layout.var_names:
    if registry.is_static(name):
      out[name] = packed[..., idx]
      idx += 1
      continue
    t = layout.num_times
    if registry.is_atmospheric(name):
      c = t * nl
      x = packed[..., idx:idx + c]
      b, la, lo = x.shape[:3]
      out[name] = moveaxis(x.reshape(b, la, lo, t, nl), (3, 4), (1, 2))
      idx += c
    else:
      out[name] = moveaxis(packed[..., idx:idx + t], 3, 1)
      idx += t
  if idx != layout.num_channels:
    raise ValueError(f'unpacked {idx} of {layout.num_channels} channels')
  return out


def merge_permutation(a: ChannelLayout, b: ChannelLayout
                      ) -> Tuple[ChannelLayout, np.ndarray]:
  """Layout for the union of two disjoint variable sets plus the static
  gather that maps concat([packed_a, packed_b], axis=-1) onto it
  (the reference's `forcings.assign(noisy_targets)` re-stacking)."""
  if set(a.var_names) & set(b.var_names):
    raise ValueError('merge requires disjoint variable sets')
  if a.num_times != b.num_times:
    raise ValueError('merge requires equal frame counts')
  if a.pressure_levels != b.pressure_levels:
    raise ValueError('merge requires identical level tables')
  merged = build_layout(a.var_names + b.var_names, a.pressure_levels,
                        a.num_times)
  perm = np.empty(merged.num_channels, dtype=np.int32)
  for c in range(merged.num_channels):
    name = merged.var_names[merged.channel_var[c]]
    src, offset = (a, 0) if name in a.var_names else (b, a.num_channels)
    vi = src.var_names.index(name)
    match = np.nonzero((src.channel_var == vi)
                       & (src.channel_time == merged.channel_time[c])
                       & (src.channel_level == merged.channel_level[c]))[0]
    if match.size != 1:
      raise ValueError(f'channel {c} of the merged layout has '
                       f'{match.size} sources')
    perm[c] = offset + match[0]
  return merged, perm


# ---------------------------------------------------------------------------
# Per-(variable, level) statistics -> per-channel vectors.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stats:
  """Normalization statistics.

  Maps variable name -> scalar (surface) or [num_levels] array (atmospheric),
  mirroring the reference's {mean,stddev,diffs_stddev}_by_level datasets.
  """
  mean: Mapping[str, np.ndarray]
  std: Mapping[str, np.ndarray]
  diffs_std: Mapping[str, np.ndarray]

  @classmethod
  def unit(cls, var_names: Sequence[str],
           pressure_levels: Sequence[int]) -> 'Stats':
    nl = len(pressure_levels)
    def table(value):
      return {n: (np.full(nl, value) if registry.is_atmospheric(n)
                  else np.asarray(value)) for n in var_names}
    return cls(mean=table(0.0), std=table(1.0), diffs_std=table(1.0))


def _per_channel(layout: ChannelLayout, table: Mapping[str, np.ndarray],
                 default: float) -> np.ndarray:
  out = np.full(layout.num_channels, default, dtype=np.float32)
  for c in range(layout.num_channels):
    name = layout.var_names[layout.channel_var[c]]
    if name not in table:
      continue
    v = np.asarray(table[name])
    lvl = layout.channel_level[c]
    out[c] = v if v.ndim == 0 else v[lvl]
  return out


def channel_locations(layout: ChannelLayout, stats: Stats) -> np.ndarray:
  return _per_channel(layout, stats.mean, 0.0)


def channel_scales(layout: ChannelLayout, stats: Stats) -> np.ndarray:
  return _per_channel(layout, stats.std, 1.0)


def channel_residual_scales(layout: ChannelLayout, stats: Stats) -> np.ndarray:
  return _per_channel(layout, stats.diffs_std, 1.0)


def residual_channel_map(target_layout: ChannelLayout,
                         input_layout: ChannelLayout) -> np.ndarray:
  """For each target channel, the input channel holding the same variable &
  level at the LAST input frame, or -1 if the variable is not an input
  (prediction = residual + last input frame)."""
  last_t = input_layout.num_times - 1
  out = np.full(target_layout.num_channels, -1, dtype=np.int32)
  for c in range(target_layout.num_channels):
    name = target_layout.var_names[target_layout.channel_var[c]]
    if name not in input_layout.var_names:
      continue
    vi = input_layout.var_names.index(name)
    match = np.nonzero(
        (input_layout.channel_var == vi)
        & (input_layout.channel_time == (0 if registry.is_static(name)
                                         else last_t))
        & (input_layout.channel_level == target_layout.channel_level[c]))[0]
    if match.size:
      out[c] = match[0]
  return out


@dataclasses.dataclass(frozen=True)
class RolloutMaps:
  """Static channel maps for autoregressive frame composition.

  For each input channel, `source` says where its value comes from when
  advancing one step (dropping the oldest frame, appending the new one):
    0 = shift: from input channel `index` (same var, next frame)
    1 = prediction: from target channel `index`
    2 = forcing: from forcing channel `index` (new-frame forcings)
    3 = keep: static variable, value unchanged
  """
  source: np.ndarray  # [C_in] int32 in {0,1,2,3}
  index: np.ndarray   # [C_in] int32


def rollout_maps(inputs: ChannelLayout, targets: ChannelLayout,
                 forcings: ChannelLayout) -> RolloutMaps:
  """Builds the frame-advance maps (the packed-array form of the
  reference's host-side frame composition)."""
  last_t = inputs.num_times - 1
  source = np.full(inputs.num_channels, -1, dtype=np.int32)
  index = np.zeros(inputs.num_channels, dtype=np.int32)

  def find(lay: ChannelLayout, name: str, t: int, lvl: int) -> int:
    if name not in lay.var_names:
      return -1
    vi = lay.var_names.index(name)
    m = np.nonzero((lay.channel_var == vi) & (lay.channel_time == t)
                   & (lay.channel_level == lvl))[0]
    return int(m[0]) if m.size else -1

  for c in range(inputs.num_channels):
    name = inputs.var_names[inputs.channel_var[c]]
    t = inputs.channel_time[c]
    lvl = inputs.channel_level[c]
    if registry.is_static(name):
      source[c] = 3
      continue
    if t < last_t:
      source[c] = 0
      index[c] = find(inputs, name, t + 1, lvl)
      if index[c] < 0:
        raise ValueError(f'input variable {name} has no frame {t + 1}')
      continue
    # Newest frame: predicted target or new-frame forcing.
    p = find(targets, name, 0, lvl)
    if p >= 0:
      source[c] = 1
      index[c] = p
      continue
    f = find(forcings, name, 0, lvl)
    if f >= 0:
      source[c] = 2
      index[c] = f
      continue
    raise ValueError(
        f'input variable {name} is neither predicted nor a forcing; '
        'cannot advance the rollout window')
  return RolloutMaps(source=source, index=index)


def loss_channel_weights(
    layout: ChannelLayout,
    per_variable_weights: Mapping[str, float],
) -> Tuple[np.ndarray, np.ndarray]:
  """(total_weights, per_var_mean_weights), each [C] float32.

  total_weights: w_var * level_weight / channels_of_var; summing
    channel-meaned errors with these weights gives the reference's
    per-variable mean over (time, level) with pressure-proportional level
    weights, then the weighted sum over variables.
  per_var_mean_weights: level_weight / channels_of_var, for the
    per-variable diagnostic losses.
  """
  levels = np.asarray(layout.pressure_levels, dtype=np.float64)
  level_w = levels / levels.mean() if levels.size else levels
  total = np.zeros(layout.num_channels, dtype=np.float32)
  diag = np.zeros(layout.num_channels, dtype=np.float32)
  counts = layout.channels_per_var()
  for c in range(layout.num_channels):
    name = layout.var_names[layout.channel_var[c]]
    lvl = layout.channel_level[c]
    lw = float(level_w[lvl]) if lvl >= 0 else 1.0
    diag[c] = lw / counts[name]
    total[c] = per_variable_weights.get(name, 1.0) * diag[c]
  return total, diag


def latitude_weights(lat_deg: np.ndarray) -> np.ndarray:
  """Unit-mean area weights per latitude row, for equiangular grids with or
  without pole points."""
  lat = np.asarray(lat_deg, dtype=np.float64)
  d = np.diff(lat)
  if not np.allclose(d[0], d):
    raise ValueError('latitudes must be uniformly spaced')
  dlat = abs(d[0])
  if np.any(np.isclose(np.abs(lat), 90.0)):
    if not (np.isclose(abs(lat).max(), 90.0) and np.isclose(lat.min(), -90.0)):
      raise ValueError('grid with poles must span [-90, 90]')
    w = np.cos(np.deg2rad(lat)) * np.sin(np.deg2rad(dlat / 2))
    pole = np.sin(np.deg2rad(dlat / 4)) ** 2
    w[np.isclose(np.abs(lat), 90.0)] = pole
  else:
    if not (np.isclose(np.max(lat), 90 - dlat / 2)
            and np.isclose(np.min(lat), -90 + dlat / 2)):
      raise ValueError('poleless grid must start/end at +-(90 - dlat/2)')
    w = np.cos(np.deg2rad(lat))
  return (w / w.mean()).astype(np.float32)
