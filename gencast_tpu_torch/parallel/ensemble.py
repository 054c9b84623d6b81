"""Ensemble forecasts on one device.

Counterpart of `gencast_tpu.parallel.ensemble` (`member_keys`,
`ensemble_rollout`, `ensemble_statistics`) without the mesh: members run
one after another on the model's device, each its own sampled rollout, and
go to the host as they end, so the device never holds more than one group
of members. Member `m` draws from a generator seeded from (seed, m) alone, the
reference's fold_in(key, m), so a member's forecast does not depend on how
many members run or in what groups. Sharding members over devices comes
with ROADMAP.md, "Still to port": Parallelism.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from gencast_tpu_torch import rollout as rollout_lib
from gencast_tpu_torch.models import diffusion_utils


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
  advances every member's window with the ground truth. Each group of
  `member_chunk` finished members (default 1) is copied to the host before
  the next begins (the reference's --member_chunk); the grouping does not
  change a member's forecast. `jit` goes to `rollout.sample_rollout`: on
  the card, True replays each denoiser call from a CUDA graph. With
  `chunk_size`, each member's rollout runs through
  `rollout.chunked_rollout` (its steps `chunk_size` at a time, moved to the
  host as they end, with `overlap_offload`): the same forecast, with at
  most a chunk of steps on the device.
  """
  if noise is not None:
    draws = [{'noise': member_noise} for member_noise in noise]
  else:
    if keys is None:
      if seed is None or num_members is None:
        raise ValueError('ensemble_rollout needs seed and num_members, keys '
                         'or noise')
      keys = member_keys(seed, num_members, device=inputs.device)
    draws = [{'generator': key} for key in keys]
  chunk = member_chunk or 1
  if chunk < 1:
    raise ValueError(f'member_chunk must be positive, got {member_chunk}')
  if chunk_size is not None:
    def member(draw):
      return rollout_lib.chunked_rollout(
          model, inputs, forcings, draw.get('generator'),
          noise=draw.get('noise'), chunk_size=chunk_size,
          teacher_targets=teacher_targets, overlap_offload=overlap_offload,
          jit=jit)
  else:
    def member(draw):
      return rollout_lib.sample_rollout(
          model, inputs, forcings, teacher_targets=teacher_targets, jit=jit,
          **draw)
  out = None
  for lo in range(0, len(draws), chunk):
    group = torch.stack([member(draw) for draw in draws[lo:lo + chunk]])
    if out is None:
      out = torch.empty((len(draws),) + group.shape[1:], dtype=group.dtype)
    out[lo:lo + group.shape[0]].copy_(group)
  return out


def ensemble_statistics(members: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Mean and standard deviation (ddof 1; zeros for one member) over the
  member axis."""
  mean = members.mean(dim=0)
  std = (members.std(dim=0, correction=1) if members.shape[0] > 1
         else torch.zeros_like(mean))
  return mean, std
