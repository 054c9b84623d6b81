"""Ensemble forecasts, on one device or sharded over ranks.

Counterpart of `gencast_tpu.parallel.ensemble`. Member `m` draws from a
generator seeded from (seed, m) alone, the reference's fold_in(key, m), so
a member's forecast does not depend on how many members run, in what
groups, or on which rank.

- One device (`ensemble_rollout`, the default path): the members run as
  one batch (the reference's `jax.vmap` over member keys), or in groups of
  `member_chunk` members, each group one batched sampled rollout whose
  denoiser calls sample all its members at once; each group goes to the
  host as it ends, so the device never holds more than one group.
- Over the 'ensemble' axis of a `parallel.meshes.Mesh` (one process per
  rank): `make_ensemble_rollout` and `ensemble_sample` run on rank e the
  members [e·M/E, (e+1)·M/E), as one batch, and keep them on its device;
  `ensemble_statistics` and `ensemble_scores` reduce over the ranks on the
  devices, so only [..., C] scores reach the host. `ensemble_scores`
  reshards members to latitude bands first, as the reference's one
  all-to-all, here an `all_reduce` of a [M, band, ...] buffer per band
  filled with -0.0 but for each rank's own members (x + -0.0 is x, bit for
  bit): gloo on CUDA tensors has only `broadcast` and `all_reduce`, and the
  ranks may share a card. `gather_members` gathers the same way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from gencast_tpu_torch import rollout as rollout_lib
from gencast_tpu_torch.models import diffusion_utils
from gencast_tpu_torch.ops import metrics


def member_keys(seed: int, num_members: int,
                device: torch.device | str = 'cpu') -> List[torch.Generator]:
  """One generator per member, member m's seeded from (seed, m)."""
  return [diffusion_utils.keyed_generator(seed, m, device=device)
          for m in range(num_members)]


def ensemble_rollout(model: nn.Module,
                     inputs: torch.Tensor,      # [B, lat, lon, C_in]
                     forcings: torch.Tensor,    # [K, B, lat, lon, C_frc]
                     seed: Optional[int] = None,
                     num_members: Optional[int] = None,
                     teacher_targets: Optional[torch.Tensor] = None,
                     keys: Optional[Sequence[torch.Generator]] = None,
                     noise: Optional[Sequence] = None,
                     member_chunk: Optional[int] = None,
                     jit: bool = True,
                     chunk_size: Optional[int] = None,
                     overlap_offload: bool = True) -> torch.Tensor:
  """A K-step sampled ensemble forecast, on the host:
  [M, K, B, lat, lon, C_tgt].

  Randomness per member from `keys` (generators; default
  member_keys(seed, num_members) on the inputs' device), or from `noise`:
  for each member, each step's N + 1 unit noise fields (as
  `rollout.sample_rollout` takes them). teacher_targets [K, B, ...]
  advances every member's window with the ground truth. The members run
  `member_chunk` at a time as one batch (`rollout.sample_rollout` given a
  group's generators or noise), all of them at once by default (None, the
  reference's vmapped ensemble), and each group is copied to the host
  before the next begins (the reference's --member_chunk); a member's
  forecast is that of its own draws however the members are grouped.
  `jit` goes to `rollout.sample_rollout`: on the card, True replays each
  denoiser call from a CUDA graph of the group's batch. With `chunk_size`
  each member runs alone through `rollout.chunked_rollout` (its steps
  `chunk_size` at a time, moved to the host as they end, with
  `overlap_offload`), as the reference's --chunk_size streams members
  singly; `member_chunk` is then not used.
  """
  if noise is not None:
    draws, one, many = noise, 'noise', 'noise'
  else:
    if keys is None:
      if seed is None or num_members is None:
        raise ValueError('ensemble_rollout needs seed and num_members, keys '
                         'or noise')
      keys = member_keys(seed, num_members, device=inputs.device)
    draws, one, many = keys, 'generator', 'generators'
  if member_chunk is not None and member_chunk < 1:
    raise ValueError(f'member_chunk must be positive, got {member_chunk}')
  if chunk_size is not None:
    def run(group):
      return torch.stack([rollout_lib.chunked_rollout(
          model, inputs, forcings, chunk_size=chunk_size,
          teacher_targets=teacher_targets, overlap_offload=overlap_offload,
          jit=jit, **{one: draw}) for draw in group])
    size = 1
  else:
    def run(group):
      return rollout_lib.sample_rollout(
          model, inputs, forcings, teacher_targets=teacher_targets, jit=jit,
          **{many: list(group)})
    size = member_chunk or len(draws)
  out = None
  for lo in range(0, len(draws), size):
    members = run(draws[lo:lo + size])
    if out is None:
      out = torch.empty((len(draws),) + members.shape[1:],
                        dtype=members.dtype)
    out[lo:lo + members.shape[0]].copy_(members)
  return out


def member_range(num_members: int, mesh=None) -> Tuple[int, int]:
  """[lo, hi): the members this rank runs, [e·M/E, (e+1)·M/E) of its
  ensemble coordinate e (all of them without a mesh)."""
  if mesh is None:
    return 0, num_members
  e, i = mesh.axis_size('ensemble'), mesh.coords['ensemble']
  if num_members < e:
    raise ValueError(f'{num_members} members over an ensemble axis of {e}: '
                     'a rank would run none')
  return i * num_members // e, (i + 1) * num_members // e


def make_ensemble_rollout(model: nn.Module, mesh=None,
                          teacher_targets: Optional[torch.Tensor] = None,
                          jit: bool = True):
  """The member-sharded ensemble rollout: fn(inputs [B, lat, lon, C_in],
  forcings [K, B, lat, lon, C_frc], seed, members) -> this rank's share of
  the members' K-step sampled rollouts, [m, K, B, lat, lon, C_tgt] on the
  model's device. `members` are global member ids (a chunk of the
  ensemble); rank e runs `member_range(len(members), mesh)` of them as one
  batch, member m from the generator of (seed, m). `jit` as in
  `ensemble_rollout`."""

  def run(inputs, forcings, seed: int, members: Sequence[int]):
    lo, hi = member_range(len(members), mesh)
    return rollout_lib.sample_rollout(
        model, inputs, forcings, generators=[
            diffusion_utils.keyed_generator(seed, int(m), device=inputs.device)
            for m in members[lo:hi]],
        teacher_targets=teacher_targets, jit=jit)

  return run


def ensemble_sample(model: nn.Module, inputs: torch.Tensor,
                    forcings: torch.Tensor, seed: int, num_members: int,
                    mesh=None, jit: bool = True) -> torch.Tensor:
  """num_members independent samples of one step, member m from the
  generator of (seed, m): this rank's share `member_range(num_members,
  mesh)`, sampled as one batch, [m, B, lat, lon, C] on the model's device
  (all of them without a mesh)."""
  lo, hi = member_range(num_members, mesh)
  out = model.sample(
      torch.cat([inputs] * (hi - lo)), torch.cat([forcings] * (hi - lo)),
      generators=[diffusion_utils.keyed_generator(seed, m,
                                                  device=inputs.device)
                  for m in range(lo, hi)], graphed=jit)
  return out.unflatten(0, (hi - lo, inputs.shape[0]))


def _ensemble_group(mesh):
  return None if mesh is None else mesh.group('ensemble')


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
  import torch.distributed as dist
  dist.all_reduce(x, group=group)
  return x


def _member_counts(local: torch.Tensor, mesh) -> List[int]:
  """The member count of every rank of the ensemble axis, in order."""
  counts = torch.zeros(mesh.axis_size('ensemble'), dtype=torch.float32,
                       device=local.device)
  counts[mesh.coords['ensemble']] = local.shape[0]
  return [int(c) for c in _all_reduce(counts, _ensemble_group(mesh)).tolist()]


def _members_of(local: torch.Tensor, counts: List[int], mesh
                ) -> torch.Tensor:
  """Every rank's `local` members stacked [M, ...] on every rank: an
  all_reduce of a buffer of -0.0 holding this rank's own members."""
  buf = torch.full((sum(counts),) + tuple(local.shape[1:]), -0.0,
                   dtype=local.dtype, device=local.device)
  lo = sum(counts[:mesh.coords['ensemble']])
  buf[lo:lo + local.shape[0]] = local
  return _all_reduce(buf, _ensemble_group(mesh))


def gather_members(local: torch.Tensor, mesh=None) -> torch.Tensor:
  """All members [M, ...] on every rank of the ensemble axis, in member
  order, bitwise the ranks' own; `local` as it is without a mesh."""
  if mesh is None or mesh.axis_size('ensemble') == 1:
    return local
  return _members_of(local, _member_counts(local, mesh), mesh)


def ensemble_statistics(members: torch.Tensor, mesh=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Mean and standard deviation (ddof 1; zeros for one member) over the
  member axis; under a mesh, over every rank's members (`members` is this
  rank's share), reduced on the devices and the same on every rank."""
  if mesh is None or mesh.axis_size('ensemble') == 1:
    mean = members.mean(dim=0)
    std = (members.std(dim=0, correction=1) if members.shape[0] > 1
           else torch.zeros_like(mean))
    return mean, std
  group = _ensemble_group(mesh)
  total = sum(_member_counts(members, mesh))
  mean = _all_reduce(members.sum(dim=0), group) / total
  if total == 1:
    return mean, torch.zeros_like(mean)
  sq = _all_reduce(((members - mean) ** 2).sum(dim=0), group)
  return mean, torch.sqrt(sq / (total - 1))


def ensemble_scores(members: torch.Tensor, truth: torch.Tensor,
                    lat_weights: torch.Tensor, mesh=None
                    ) -> Dict[str, torch.Tensor]:
  """CRPS, ensemble-mean RMSE and spread per channel, reduced on the
  devices: {'crps', 'rmse', 'spread'}, [..., C] tensors (`ops.metrics`).

  members [M, ..., lat, lon, C] (under a mesh, this rank's share), truth
  [..., lat, lon, C], lat_weights [lat]. Under a mesh the members are
  resharded to latitude bands, band e (rows [e·L/E, (e+1)·L/E)) to rank e
  of the ensemble axis, each rank scores its band's members, and the
  bands' sums are added over the ranks: every rank returns the same
  scores, as ops.metrics gives on the gathered members up to float32
  summation order."""
  if mesh is None or mesh.axis_size('ensemble') == 1:
    return {'crps': metrics.crps_ensemble(members, truth, lat_weights),
            'rmse': metrics.ensemble_mean_rmse(members, truth, lat_weights),
            'spread': metrics.ensemble_spread(members, lat_weights)}
  e, mine = mesh.axis_size('ensemble'), mesh.coords['ensemble']
  nlat, nlon = truth.shape[-3], truth.shape[-2]
  counts = _member_counts(members, mesh)
  for owner in range(e):
    rows = slice(owner * nlat // e, (owner + 1) * nlat // e)
    got = _members_of(members[..., rows, :, :], counts, mesh)
    if owner == mine:
      band, band_rows = got, rows
  sums = torch.stack(metrics.weighted_sums(
      band, truth[..., band_rows, :, :], lat_weights[band_rows]))
  crps, mse, var = _all_reduce(sums, _ensemble_group(mesh)) / (nlat * nlon)
  return {'crps': crps, 'rmse': torch.sqrt(mse), 'spread': torch.sqrt(var)}
