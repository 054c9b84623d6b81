"""Peaks of one H100 SXM and the least time a kernel's work could take:
a frozen copy of the program's kernel-bound arithmetic (`chip_smoke.py`),
with the operation and byte counts of the block-sparse attention kernels.

The bound of a launch is the larger of its operations over the peak rate
of its type and its bytes over the memory rate, counting each input and
output once. Operations count only the mask's allowed (query, key)
entries; bytes count q, k, v, the outputs and the per-row statistics, and
not the tile plan, so the bound is a floor and the share cannot pass 100%
unless the kernel beats the card.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, moved: float, bf16: bool = True) -> float:
  peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
  return max(flops / peak, moved / PEAK_HBM_BYTES)


def binds(flops: float, moved: float, bf16: bool = True) -> str:
  peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
  return 'operations' if flops / peak > moved / PEAK_HBM_BYTES else 'bytes'


def attention_costs(batch: int, nodes: int, heads: int, head_dim: int,
                    pairs: int, elem: int = 2) -> dict:
  """(operations, bytes) of one launch of kernel A (forward), F-dq and
  F-dk/dv (backward) over `batch` rows of `nodes` mesh nodes with `pairs`
  allowed entries per head: 4, 6 and 8 d operations per entry; q, k, v,
  dO and the outputs of `elem` bytes, the log-sum-exp and delta rows in
  float32."""
  t = batch * nodes * heads * head_dim * elem
  rows = batch * heads * nodes * 4
  ops = batch * heads * head_dim * pairs
  return {'A': (4 * ops, 4 * t + rows),
          'F-dq': (6 * ops, 5 * t + 2 * rows),
          'F-dk/dv': (8 * ops, 6 * t + 2 * rows)}
