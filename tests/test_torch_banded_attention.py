"""The port's tri-block attention (plain versions of kernels C and D)
against the JAX package's Pallas kernels, run in interpret mode on CPU.

Block sizes are not multiples of 64 (the kernels' sub-tile), the first and
last blocks' missing neighbours are all False, and the last block holds
padding rows that see no key at all, as the transformer's padded nodes.
Inputs come from numpy seeds and go to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.ops import banded_attention as jax_ba
from gencast_tpu_torch.ops import banded_attention as ba
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Forward, float32: the same f32 arithmetic in another summation order
# (joint three-block max and sum vs einsums).
FWD_ATOL = 1e-5
# Gradients, float32: as the reference's own Pallas-vs-oracle check
# (tests/test_banded_attention.py), the two backward kernels vs explicit
# three-block einsums.
GRAD_ATOL = 2e-5


def _mask(nb, bs, pad, seed, density=0.3):
  """[3, nb, bs, bs] bool: random, the diagonal always allowed, the missing
  neighbours all False, and the last `pad` nodes fully masked as queries and
  as keys."""
  rng = np.random.default_rng(seed)
  m = rng.random((3, nb, bs, bs)) < density
  for j in range(nb):
    np.fill_diagonal(m[0, j], True)
  m[1, nb - 1] = False
  m[2, 0] = False
  m[0, nb - 1, bs - pad:, :] = False
  m[0, nb - 1, :, bs - pad:] = False
  m[1, nb - 2, :, bs - pad:] = False
  m[2, nb - 1, bs - pad:, :] = False
  return m


def _inputs(shape, seed, count=4):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


# (nb, bs, heads, head_dim, padding rows): blocks of 24 and 40 rows, the
# ragged widths of TINY's 88 and nano's 656 blocks past their last full
# 64-row sub-tile.
CASES = [(3, 24, 2, 8, 5), (2, 40, 1, 16, 9)]


@pytest.mark.parametrize('nb,bs,h,d,pad', CASES)
def test_plain_forward_matches_pallas_and_xla(nb, bs, h, d, pad):
  mask = _mask(nb, bs, pad, seed=nb)
  q, k, v, _ = _inputs((2, nb * bs, h, d), seed=bs)
  jq, jk, jv = map(jnp.asarray, (q, k, v))
  jmask = jnp.asarray(mask.astype(np.uint8))
  want, (_, _, _, jlse) = jax_ba._banded_attention_fwd_impl(jq, jk, jv, jmask,
                                                            bs)
  xla = np.asarray(jax_ba.banded_attention(jq, jk, jv, jmask, bs))
  got, lse = ba.banded_attention_plain(
      *map(torch.as_tensor, (q, k, v)), torch.as_tensor(mask), bs,
      return_lse=True)
  got, lse = got.numpy(), lse.numpy()
  np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL, rtol=0)
  np.testing.assert_allclose(got, xla, atol=FWD_ATOL, rtol=0)
  # lse: JAX's [B * H, N, 1] is the port's [B, H, N]; rows that see a key
  # agree, rows that see none are +1e30 on both sides and give o = 0.
  jlse = np.asarray(jlse).reshape(lse.shape)
  seen = mask.any(axis=(0, 3)).reshape(-1)  # [N]: some part allows a key
  np.testing.assert_allclose(lse[:, :, seen], jlse[:, :, seen],
                             atol=FWD_ATOL, rtol=0)
  assert (lse[:, :, ~seen] == 1e30).all() and (jlse[:, :, ~seen] == 1e30).all()
  assert (~seen).sum() == pad and (got[:, ~seen] == 0).all()


@pytest.mark.parametrize('nb,bs,h,d,pad', CASES)
def test_plain_backward_matches_jax_vjp(nb, bs, h, d, pad):
  mask = _mask(nb, bs, pad, seed=nb + 1)
  q, k, v, cot = _inputs((1, nb * bs, h, d), seed=bs + 1)
  jmask = jnp.asarray(mask.astype(np.uint8))

  def f(q, k, v):
    return jax_ba.banded_attention(q, k, v, jmask, bs)

  _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
  want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]

  tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
  out = ba.banded_attention(tq, tk, tv, torch.as_tensor(mask), bs)
  out.backward(torch.as_tensor(cot))
  for name, t, w in zip('qkv', (tq, tk, tv), want):
    np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL, rtol=0,
                               err_msg=f'd{name}')
  # Padded query rows see no key: dq is exactly 0 there.
  assert (tq.grad[0, nb * bs - pad:] == 0).all()
  assert torch.isfinite(tk.grad).all() and torch.isfinite(tv.grad).all()


def test_plain_dq_dkv_take_jax_residuals():
  """Fed JAX's own lse (+1e30 on empty rows) and delta, the plain dq and
  dk/dv equal JAX's interpreted _dq_kernel and _dkv_kernel."""
  nb, bs, h, d, pad = 3, 24, 2, 8, 7
  mask = _mask(nb, bs, pad, seed=11)
  q, k, v, cot = _inputs((1, nb * bs, h, d), seed=12)
  jmask = jnp.asarray(mask.astype(np.uint8))
  jq, jk, jv, jcot = map(jnp.asarray, (q, k, v, cot))
  o, res = jax_ba._banded_attention_fwd(jq, jk, jv, jmask, bs)
  want = [np.asarray(g) for g in jax_ba._banded_attention_bwd(bs, res,
                                                              jcot)[:3]]
  lse = torch.as_tensor(np.array(res[3])).reshape(1, h, nb * bs)
  to = torch.as_tensor(np.array(o))
  tq, tk, tv, tcot = map(torch.as_tensor, (q, k, v, cot))
  delta = ba.attention_delta(to, tcot)
  tmask = torch.as_tensor(mask.astype(np.uint8))
  dq = ba.banded_attention_dq_plain(tq, tk, tv, tcot, lse, delta, tmask, bs)
  dk, dv = ba.banded_attention_dkv_plain(tq, tk, tv, tcot, lse, delta, tmask,
                                         bs)
  for name, got, w in zip('qkv', (dq, dk, dv), want):
    np.testing.assert_allclose(got.numpy(), w, atol=GRAD_ATOL, rtol=0,
                               err_msg=f'd{name}')


def test_plain_gradcheck_float64():
  """The plain backward is the derivative of the plain forward (float64,
  finite differences)."""
  nb, bs, h, d, pad = 2, 8, 1, 4, 3
  mask = torch.as_tensor(_mask(nb, bs, pad, seed=3, density=0.5))
  rng = np.random.default_rng(4)
  args = [torch.tensor(rng.standard_normal((1, nb * bs, h, d)),
                       requires_grad=True) for _ in range(3)]
  assert torch.autograd.gradcheck(
      lambda q, k, v: ba.banded_attention(q, k, v, mask, bs), args)


def test_bf16_plain_rounds_operands():
  """bf16 inputs: the plain versions compute in float32 and return bf16,
  near the float32 result of the same (bf16-valued) inputs."""
  nb, bs, h, d, pad = 2, 24, 2, 8, 4
  mask = torch.as_tensor(_mask(nb, bs, pad, seed=5))
  q, k, v, cot = (torch.as_tensor(x).to(torch.bfloat16)
                  for x in _inputs((1, nb * bs, h, d), seed=6))
  o, lse = ba.banded_attention_plain(q, k, v, mask, bs, return_lse=True)
  o32, lse32 = ba.banded_attention_plain(q.float(), k.float(), v.float(),
                                         mask, bs, return_lse=True)
  assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
  torch.testing.assert_close(lse, lse32)
  # One bf16 rounding of each output element.
  assert float((o.float() - o32).abs().max()) <= 2 ** -8 * float(
      o32.abs().max())
  dq, dk, dv = ba.banded_attention_bwd_plain(q, k, v, o, lse, cot, mask, bs)
  assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
             for g in (dq, dk, dv))


def test_cuda_wrappers_raise_on_cpu_tensors():
  """The kernel wrappers launch only on the card: CPU tensors raise before
  anything is built or counted."""
  nb, bs, h, d = 2, 24, 2, 32
  x = torch.zeros(1, nb * bs, h, d)
  mask = torch.zeros(3, nb, bs, bs, dtype=torch.uint8)
  rows = torch.zeros(1, h, nb * bs)
  for c in (ba.KERNEL, ba.KERNEL_DQ, ba.KERNEL_DKV):
    c.reset()
  with pytest.raises(ValueError, match='must be on'):
    ba.banded_attention_fwd_cuda(x, x, x, mask, bs)
  with pytest.raises(ValueError, match='must be on'):
    ba.banded_attention_dq_cuda(x, x, x, x, rows, rows, mask, bs)
  with pytest.raises(ValueError, match='must be on'):
    ba.banded_attention_dkv_cuda(x, x, x, x, rows, rows, mask, bs)
  with pytest.raises(TypeError, match='float32 or bfloat16'):
    ba.banded_attention_fwd_cuda(x.double(), x.double(), x.double(), mask, bs)
  assert all(c.launches == 0 for c in (ba.KERNEL, ba.KERNEL_DQ,
                                       ba.KERNEL_DKV))
