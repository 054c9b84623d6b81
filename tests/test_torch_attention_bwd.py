"""Kernel F's plain versions (the block-sparse attention backward) against
the JAX package's gradient.

The JAX `sparse_banded_attention` custom VJP runs its Pallas dq and dk/dv
kernels in interpret mode on the CPU. The port's autograd Function takes
the plain backward on CPU tensors; the CUDA kernels run only on the card,
where chip_smoke.py holds them against these plain versions. The port's
plan is built at its own tile (16 or 24, the reference's at 32) and N is a
multiple of neither, so padded rows, partial tiles and rows without any
allowed key are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sp

from gencast_tpu.ops import sparse_attention as jax_sa
from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.ops import sparse_attention

# max|port - jax| / max|jax| per gradient: both float32; online vs
# two-pass softmax and matmul order differ.
F32_RTOL = 1e-5


def _mask(n, bandwidth, seed, empty_rows=(), density=0.3):
  rng = np.random.default_rng(seed)
  rows, cols = [], []
  for i in range(n):
    if i in empty_rows:
      continue
    cand = np.arange(max(0, i - bandwidth), min(n, i + bandwidth + 1))
    sel = np.union1d(cand[rng.random(cand.size) < density], [i])
    rows.extend([i] * sel.size)
    cols.extend(sel.tolist())
  return sp.csr_matrix((np.ones(len(rows), bool), (rows, cols)), shape=(n, n))


def _plan_tensors(plan):
  return tuple(torch.as_tensor(a) for a in (
      plan.mask_tiles, plan.fwd_kv_ids, plan.fwd_pair_ids, plan.bwd_q_ids,
      plan.bwd_pair_ids))


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('n,bandwidth,port_tile,heads,d', [
    (100, 20, 16, 2, 32), (150, 45, 24, 4, 16)])
def test_plain_backward_matches_jax(n, bandwidth, port_tile, heads, d):
  mask = _mask(n, bandwidth, seed=n, empty_rows=(3, n - 2))
  ref_plan = jax_sa.build_tile_plan(mask, tile=32)
  port_plan = plans.build_tile_plan(mask, tile=port_tile)
  rng = np.random.default_rng(1)
  q, k, v, dout = (rng.standard_normal((2, n, heads, d)).astype(np.float32)
                   for _ in range(4))

  def f(q, k, v):
    return jax_sa.sparse_banded_attention(
        q, k, v, jnp.asarray(ref_plan.mask_tiles),
        jnp.asarray(ref_plan.fwd_kv_ids), jnp.asarray(ref_plan.fwd_pair_ids),
        (jnp.asarray(ref_plan.bwd_q_ids), jnp.asarray(ref_plan.bwd_pair_ids)),
        (ref_plan.tile, ref_plan.num_active_fwd, ref_plan.num_active_bwd))
  _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

  tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
  out = sparse_attention.sparse_banded_attention(
      tq, tk, tv, *_plan_tensors(port_plan)[:3], port_plan.tile,
      *_plan_tensors(port_plan)[3:])
  out.backward(torch.as_tensor(dout))
  for name, t, w in zip(('dq', 'dk', 'dv'), (tq, tk, tv), want):
    assert t.grad.dtype == torch.float32, name
    assert _rel(t.grad.numpy(), w) <= F32_RTOL, name
  # A row without keys has zero output and zero dq.
  assert torch.all(tq.grad[:, 3] == 0) and torch.all(out[:, 3] == 0)
  assert sparse_attention.KERNEL_DQ.launches == 0
  assert sparse_attention.KERNEL_DKV.launches == 0


def test_backward_gradcheck_float64():
  """The plain backward against numerical derivatives (gradcheck) and
  against autograd through the plain forward, in float64, with a padded
  last tile and a row without keys."""
  n, tile = 21, 8
  mask = _mask(n, 4, seed=0, empty_rows=(6,))
  plan = plans.build_tile_plan(mask, tile=tile)
  mt, fi, fp, bi, bp = _plan_tensors(plan)
  g = torch.Generator().manual_seed(3)
  q, k, v = (torch.randn(1, n, 2, 4, generator=g, dtype=torch.float64,
                         requires_grad=True) for _ in range(3))

  def f(q, k, v):
    return sparse_attention.sparse_banded_attention(q, k, v, mt, fi, fp,
                                                    tile, bi, bp)
  assert torch.autograd.gradcheck(f, (q, k, v))

  dout = torch.randn(1, n, 2, 4, generator=g, dtype=torch.float64)
  got = torch.autograd.grad(f(q, k, v), (q, k, v), dout)
  want = torch.autograd.grad(sparse_attention.sparse_banded_attention_plain(
      q, k, v, mt, fi, fp, tile), (q, k, v), dout)
  for a, b in zip(got, want):
    torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_plain_backward_bf16_rounds_like_the_reference():
  """bf16 inputs: the plain backward rounds w and ds to bf16 before their
  products (as the reference kernels) and returns bf16 near the float32
  gradients."""
  n, tile = 70, 32
  plan = plans.build_tile_plan(_mask(70, 10, seed=3), tile=tile)
  mt, fi, fp, bi, bp = _plan_tensors(plan)
  g = torch.Generator().manual_seed(0)
  q, k, v, dout = (torch.randn(1, n, 2, 16, generator=g) for _ in range(4))
  o, lse = sparse_attention.sparse_banded_attention_plain(
      q, k, v, mt, fi, fp, tile, return_lse=True)
  want = sparse_attention.sparse_attention_bwd_plain(
      q, k, v, o, lse, dout, mt, fi, fp, bi, bp, tile)
  qb, kb, vb, db = (t.bfloat16() for t in (q, k, v, dout))
  ob, lseb = sparse_attention.sparse_banded_attention_plain(
      qb, kb, vb, mt, fi, fp, tile, return_lse=True)
  got = sparse_attention.sparse_attention_bwd_plain(
      qb, kb, vb, ob, lseb, db, mt, fi, fp, bi, bp, tile)
  for a, b in zip(got, want):
    assert a.dtype == torch.bfloat16
    # bf16 inputs, bf16 w/ds operands and output rounding: about 1e-2 of
    # each gradient's range.
    assert (a.float() - b).abs().max() <= 3e-2 * b.abs().max()


def test_backward_wrappers_reject_cpu_tensors():
  plan = plans.build_tile_plan(_mask(64, 8, seed=4), tile=64)
  mt, fi, fp, bi, bp = _plan_tensors(plan)
  q = torch.zeros(1, 64, 2, 32)
  lse = torch.zeros(1, 2, 64)
  with pytest.raises(ValueError, match='must be on'):
    sparse_attention.sparse_attention_dq_cuda(q, q, q, q, lse, lse, mt, fi,
                                              fp, 64)
  with pytest.raises(ValueError, match='must be on'):
    sparse_attention.sparse_attention_dkv_cuda(q, q, q, q, lse, lse, mt, bi,
                                               bp, 64)
  assert sparse_attention.KERNEL_DQ.launches == 0
  assert sparse_attention.KERNEL_DKV.launches == 0
