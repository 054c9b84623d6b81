"""Ensemble forecasts on one device.

Counterpart of `gencast_tpu.parallel.ensemble` (`member_keys`,
`ensemble_rollout`, `ensemble_statistics`) without the mesh: members run
one after another on the model's device, each its own sampled rollout.
Member `m` draws from a generator seeded from (seed, m) alone, the
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
                     noise: Optional[Sequence] = None) -> torch.Tensor:
  """A K-step sampled ensemble forecast: [M, K, B, lat, lon, C_tgt].

  Randomness per member from `keys` (generators; default
  member_keys(seed, num_members) on the inputs' device), or from `noise`:
  for each member, each step's N + 1 unit noise fields (as
  `rollout.sample_rollout` takes them). teacher_targets [K, B, ...]
  advances every member's window with the ground truth.
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
  return torch.stack([
      rollout_lib.sample_rollout(model, inputs, forcings,
                                 teacher_targets=teacher_targets, **draw)
      for draw in draws])


def ensemble_statistics(members: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Mean and standard deviation (ddof 1; zeros for one member) over the
  member axis."""
  mean = members.mean(dim=0)
  std = (members.std(dim=0, correction=1) if members.shape[0] > 1
         else torch.zeros_like(mean))
  return mean, std
