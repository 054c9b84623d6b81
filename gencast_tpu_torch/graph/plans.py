"""Host-side (numpy) schedules for the port's two device kernels.

* `TilePlan` / `build_tile_plan`: the block-sparsity structure of the k-hop
  attention mask, consumed by the block-sparse attention kernel
  (ops/sparse_attention.py). Same arrays as
  `gencast_tpu.ops.sparse_attention.build_tile_plan` at the same tile,
  built with vectorized numpy instead of a per-pair loop; and
  `build_bwd_gather`, the map that sums the fused backward's dq partials
  (kernel G) by q tile.
* `AggPlan` / `plan_if_profitable`: the receiver-sorted CSR schedule for the
  planned segment sum (ops/segment.py). The reference's one-hot (tile,
  width) pair schedule was a TPU matrix-unit design and is not carried
  over; the gate that decides which edge sets get a plan is kept, so the
  port plans exactly the edge sets the reference plans.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TilePlan:
  """Static block-sparsity structure of the attention mask.

  mask_tiles: [P + 1, tile, tile] uint8 — index P is the all-zero pad tile.
  fwd_kv_ids / fwd_pair_ids: [nq, A] — kv tile & mask-tile index per
    (q tile, active slot); pad slots repeat the last kv id and point at P.
  bwd_q_ids / bwd_pair_ids: [nk, B] — reverse lists (for a backward pass).
  """
  tile: int
  padded_n: int
  mask_tiles: np.ndarray
  fwd_kv_ids: np.ndarray
  fwd_pair_ids: np.ndarray
  bwd_q_ids: np.ndarray
  bwd_pair_ids: np.ndarray

  @property
  def num_q_tiles(self) -> int:
    return self.fwd_kv_ids.shape[0]

  @property
  def num_active_fwd(self) -> int:
    return self.fwd_kv_ids.shape[1]

  @property
  def num_active_bwd(self) -> int:
    return self.bwd_q_ids.shape[1]

  @property
  def num_pairs(self) -> int:
    """Mask-tile pairs with at least one stored entry (pad tile excluded)."""
    return self.mask_tiles.shape[0] - 1


def _padded_lists(owner: np.ndarray, other: np.ndarray, pair_id: np.ndarray,
                  num_tiles: int, pad_tile: int):
  """[num_tiles, width] id/pair tables from pairs already sorted by
  (owner, other); pad slots repeat the row's last id and point at pad_tile."""
  counts = np.bincount(owner, minlength=num_tiles)
  width = max(1, int(counts.max()) if counts.size else 0)
  starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
  slot = np.arange(owner.size) - starts[owner]
  ids = np.zeros((num_tiles, width), dtype=np.int32)
  pids = np.full((num_tiles, width), pad_tile, dtype=np.int32)
  ids[owner, slot] = other
  pids[owner, slot] = pair_id
  last = ids[np.arange(num_tiles), np.maximum(counts - 1, 0)]
  pad = np.arange(width)[None, :] >= counts[:, None]
  ids = np.where(pad, last[:, None], ids).astype(np.int32)
  return ids, pids


def build_tile_plan(mask_csr, tile: int) -> TilePlan:
  """Builds the plan from a scipy sparse boolean mask [n, n]."""
  n = mask_csr.shape[0]
  nt = -(-n // tile)
  coo = mask_csr.tocsr().tocoo()
  rows = coo.row.astype(np.int64)
  cols = coo.col.astype(np.int64)
  # Pairs in (q tile, kv tile) lexicographic order; every stored entry
  # makes its pair active, stored True entries set the mask bit.
  keys = (rows // tile) * nt + cols // tile
  uniq, inverse = np.unique(keys, return_inverse=True)
  pair_q = (uniq // nt).astype(np.int64)
  pair_k = (uniq % nt).astype(np.int64)
  num_pairs = uniq.size

  mask_tiles = np.zeros((num_pairs + 1, tile, tile), dtype=np.uint8)
  on = np.asarray(coo.data, dtype=bool)
  mask_tiles[inverse[on], rows[on] % tile, cols[on] % tile] = 1

  pair_ids = np.arange(num_pairs)
  fwd_kv, fwd_pid = _padded_lists(pair_q, pair_k, pair_ids, nt, num_pairs)
  order = np.lexsort((pair_q, pair_k))
  bwd_q, bwd_pid = _padded_lists(pair_k[order], pair_q[order],
                                 pair_ids[order], nt, num_pairs)
  return TilePlan(tile=tile, padded_n=nt * tile, mask_tiles=mask_tiles,
                  fwd_kv_ids=fwd_kv, fwd_pair_ids=fwd_pid,
                  bwd_q_ids=bwd_q, bwd_pair_ids=bwd_pid)


def build_bwd_gather(plan: TilePlan) -> Tuple[np.ndarray, np.ndarray]:
  """Gather map of the fused attention backward (kernel G).

  The fused sweep writes each reverse pair's dq partial at flat slot
  `kj * B + b` (B = plan.num_active_bwd); to sum them by q tile, each
  forward slot (qi, a) needs the flat reverse slot of the same pair.
  Returns (slot_ids [nq, A] int32, valid [nq, A] float32): pad entries of
  the forward plan get slot 0 and valid 0. Same arrays as
  `gencast_tpu.ops.sparse_attention.build_bwd_gather`, built vectorized.
  """
  pad = plan.num_pairs
  # The flat reverse slot of every pair, by pair id (a pair has exactly one
  # reverse slot and one forward slot).
  slot_of_pair = np.zeros(pad + 1, np.int64)
  real = plan.bwd_pair_ids != pad
  slot_of_pair[plan.bwd_pair_ids[real]] = np.flatnonzero(real)
  valid = plan.fwd_pair_ids != pad
  slot = np.where(valid, slot_of_pair[plan.fwd_pair_ids], 0)
  return slot.astype(np.int32), valid.astype(np.float32)


def uniform_degree(segment_ids, num_segments: int) -> Optional[int]:
  """k if segment_ids == repeat(arange(num_segments), k) exactly, else None."""
  if not isinstance(segment_ids, np.ndarray):
    return None
  e = int(segment_ids.shape[0])
  if e == 0 or num_segments <= 0 or e % num_segments:
    return None
  k = e // num_segments
  if int(segment_ids[0]) != 0 or int(segment_ids[-1]) != num_segments - 1:
    return None
  expected = np.repeat(np.arange(num_segments, dtype=segment_ids.dtype), k)
  return k if np.array_equal(segment_ids, expected) else None


@dataclasses.dataclass(frozen=True)
class AggPlan:
  """CSR schedule for out[n] = sum over edges e with segment_ids[e] == n.

  segment_ids: [E] the original (possibly unsorted) ids.
  perm: [E] stable argsort of segment_ids, or None when already sorted;
    row n sums data[perm[row_ptr[n]:row_ptr[n + 1]]] in stored order.
  row_ptr: [num_segments + 1] int32 offsets into the sorted edge order.
  """
  num_segments: int
  num_edges: int
  segment_ids: np.ndarray
  row_ptr: np.ndarray
  perm: Optional[np.ndarray] = None

  @property
  def max_degree(self) -> int:
    return int(np.diff(self.row_ptr).max()) if self.num_segments else 0


def build_agg_plan(segment_ids: np.ndarray, num_segments: int) -> AggPlan:
  """Builds the CSR plan, sorting segment_ids (stably) if needed."""
  ids = np.asarray(segment_ids, dtype=np.int32)
  if ids.size and (ids.min() < 0 or ids.max() >= num_segments):
    raise ValueError('segment ids out of range')
  if np.all(np.diff(ids) >= 0):
    perm = None
    sorted_ids = ids
  else:
    perm = np.argsort(ids, kind='stable').astype(np.int32)
    sorted_ids = ids[perm]
  row_ptr = np.searchsorted(sorted_ids, np.arange(num_segments + 1),
                            side='left').astype(np.int32)
  return AggPlan(num_segments=num_segments, num_edges=int(ids.shape[0]),
                 segment_ids=ids, row_ptr=row_ptr, perm=perm)


def plan_if_profitable(segment_ids: np.ndarray, num_segments: int, *,
                       min_max_degree: int = 32) -> Optional[AggPlan]:
  """AggPlan when the degree distribution is skewed, else None.

  The same gate as the reference (`gencast_tpu.ops.segment.
  plan_if_profitable`): uniform-degree sets take the dense reshape-sum, and
  sets whose maximum degree is below `min_max_degree` take the plain
  scatter. Its threshold was measured on the TPU and has not been
  re-measured on the H100; it is kept so the port plans the same edge sets.
  """
  ids = np.asarray(segment_ids, dtype=np.int32)
  if ids.size == 0 or num_segments <= 0:
    return None
  if uniform_degree(ids, num_segments) is not None:
    return None
  max_deg = int(np.bincount(ids, minlength=num_segments).max())
  if max_deg < min_max_degree:
    return None
  return build_agg_plan(ids, num_segments)
