"""Kernel A's plain version against the JAX package's block-sparse attention.

The port's plan is built at a different tile than the reference's (16 or
24 vs 32) and N is a multiple of neither, so padded query/key rows and
partial tiles are exercised. The CUDA kernel itself runs only on the card
(chip_smoke.py compares it with this plain version there); here its
wrapper's input checks are tested.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sp

from gencast_tpu.ops import sparse_attention as jax_sa
from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.ops import sparse_attention
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Max abs error on unit-normal f32 inputs: both sides are f32; online vs
# two-pass softmax and matmul order differ.
ATOL = 1e-5


def _banded(n, bandwidth, seed, density=0.3):
  rng = np.random.default_rng(seed)
  rows, cols = [], []
  for i in range(n):
    cand = np.arange(max(0, i - bandwidth), min(n, i + bandwidth + 1))
    sel = np.union1d(cand[rng.random(cand.size) < density], [i])
    rows.extend([i] * sel.size)
    cols.extend(sel.tolist())
  return sp.csr_matrix((np.ones(len(rows), bool), (rows, cols)), shape=(n, n))


def _plan_tensors(plan):
  return (torch.as_tensor(plan.mask_tiles), torch.as_tensor(plan.fwd_kv_ids),
          torch.as_tensor(plan.fwd_pair_ids))


@pytest.mark.parametrize('n,bandwidth,port_tile,heads,d', [
    (100, 20, 16, 2, 32), (150, 45, 24, 4, 16)])
def test_plain_matches_jax(n, bandwidth, port_tile, heads, d):
  mask = _banded(n, bandwidth, seed=n)
  ref_plan = jax_sa.build_tile_plan(mask, tile=32)
  port_plan = plans.build_tile_plan(mask, tile=port_tile)
  rng = np.random.default_rng(1)
  q, k, v = (rng.standard_normal((2, n, heads, d)).astype(np.float32)
             for _ in range(3))
  want = jax_sa.sparse_banded_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
      jnp.asarray(ref_plan.mask_tiles), jnp.asarray(ref_plan.fwd_kv_ids),
      jnp.asarray(ref_plan.fwd_pair_ids),
      (jnp.asarray(ref_plan.bwd_q_ids), jnp.asarray(ref_plan.bwd_pair_ids)),
      (ref_plan.tile, ref_plan.num_active_fwd, ref_plan.num_active_bwd))
  got = sparse_attention.sparse_banded_attention(
      torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
      *_plan_tensors(port_plan), port_plan.tile)
  assert got.dtype == torch.float32 and got.shape == (2, n, heads, d)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_plain_rows_without_keys_are_zero():
  """Rows the mask leaves empty give 0, as the reference's kernel."""
  n, tile = 40, 16
  mask = _banded(n, 3, seed=0).tolil()
  mask[5, :] = False
  mask = mask.tocsr()
  mask.eliminate_zeros()
  plan = plans.build_tile_plan(mask, tile=tile)
  rng = np.random.default_rng(2)
  q, k, v = (torch.as_tensor(rng.standard_normal((1, n, 1, 8)),
                             dtype=torch.float32) for _ in range(3))
  out = sparse_attention.sparse_banded_attention_plain(
      q, k, v, *_plan_tensors(plan), tile)
  assert torch.all(out[0, 5] == 0)
  assert torch.isfinite(out).all()


def test_plain_keeps_bf16():
  mask = _banded(70, 10, seed=3)
  plan = plans.build_tile_plan(mask, tile=32)
  g = torch.Generator().manual_seed(0)
  q, k, v = (torch.randn(1, 70, 2, 16, generator=g) for _ in range(3))
  ref = sparse_attention.sparse_banded_attention_plain(
      q, k, v, *_plan_tensors(plan), 32)
  got = sparse_attention.sparse_banded_attention_plain(
      q.bfloat16(), k.bfloat16(), v.bfloat16(), *_plan_tensors(plan), 32)
  assert got.dtype == torch.bfloat16
  # bf16 inputs and output rounding: a few bf16 ulps of O(1) values.
  assert (got.float() - ref).abs().max() < 3e-2


def test_kernel_wrapper_rejects_cpu_tensors():
  """On a CPU tensor the kernel entry point raises; it never falls back."""
  mask = _banded(64, 8, seed=4)
  plan = plans.build_tile_plan(mask, tile=64)
  q = torch.zeros(1, 64, 2, 32)
  with pytest.raises(ValueError, match='must be on'):
    sparse_attention.sparse_attention_fwd_cuda(q, q, q, *_plan_tensors(plan),
                                               64)
  assert sparse_attention.KERNEL.launches == 0
