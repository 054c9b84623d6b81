"""Kernel families by name: a frozen copy of the program's table
(`training/profile_step.py`), first match wins. The bf16 kernels of A, F
and G carry `_mma` in their names and match the same parts."""

from __future__ import annotations

FAMILIES = (
    ('D-dk/dv', 'banded_attention_dkv_'),
    ('D-dq', 'banded_attention_dq_'),
    ('C', 'banded_attention_fwd_'),
    ('G', 'sparse_attention_dkvq_'),
    ('G dq reduce', 'sparse_attention_dq_reduce_'),
    ('F-dk/dv', 'sparse_attention_dkv_'),
    ('F-dq', 'sparse_attention_dq_'),
    ('A', 'sparse_attention_fwd_'),
    ('E', 'ln_film_'),
    ('B', 'segment_sum_kernel'),
    ('cuBLAS matmuls', 'gemm'),
    ('cuBLAS matmuls', 'sm90_xmma'),
    ('cuBLAS matmuls', 'nvjet'),
    ('reductions', 'reduce_kernel'),
    ('elementwise', 'elementwise_kernel'),
)


def family(name: str) -> str:
  """The family of a device operation's name ('other' where none
  matches)."""
  return next((f for f, part in FAMILIES if part in name), 'other')
