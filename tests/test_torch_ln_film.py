"""Kernel E's plain version (the LN+FiLM backward) against the JAX package.

The JAX `ln_film` custom VJP runs its Pallas backward in interpret mode on
the CPU, as tests/test_ln_film.py runs it. The port's autograd Function
takes the plain version on CPU tensors; the CUDA kernel runs only on the
card, where chip_smoke.py holds it against this same plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu.ops import ln_film as jax_lf
from gencast_tpu_torch.nn import mlp
from gencast_tpu_torch.ops import ln_film
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# float32: the same f32 formulas in another summation order; relative to
# the largest magnitude of each gradient.
F32_RTOL = 1e-5


def _rel(got, want):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(shape, b, c, seed, dtype=np.float32):
  rng = np.random.default_rng(seed)
  x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
  dy = rng.standard_normal(shape).astype(np.float32)
  scale = (1.0 + 0.1 * rng.standard_normal((b, c))).astype(np.float32)
  offset = (0.1 * rng.standard_normal((b, c))).astype(np.float32)
  if dtype != np.float32:
    x, dy, scale, offset = (np.array(jnp.asarray(a, dtype).astype(
        jnp.float32)) for a in (x, dy, scale, offset))
  return x, dy, scale, offset


def _jax_vjp(x, dy, scale, offset, batch_axis, dtype):
  cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
  _, vjp = jax.vjp(lambda a, s, o: jax_lf.ln_film(a, s, o, batch_axis),
                   cast(x), cast(scale), cast(offset))
  return [np.asarray(g, np.float32) for g in vjp(cast(dy))]


# rows 2500 > the reference kernel's 2048-row tile: a ragged last tile there.
@pytest.mark.parametrize('batch_axis', [0, 1])
@pytest.mark.parametrize('b', [1, 2])
@pytest.mark.parametrize('rows', [100, 2500])
def test_plain_backward_matches_jax_f32(batch_axis, b, rows):
  c = 128
  shape = (b, rows, c) if batch_axis == 0 else (rows, b, c)
  x, dy, scale, offset = _inputs(shape, b, c, seed=rows + b)
  want = _jax_vjp(x, dy, scale, offset, batch_axis, jnp.float32)
  got = ln_film.ln_film_bwd_plain(torch.as_tensor(x), torch.as_tensor(dy),
                                  torch.as_tensor(scale), batch_axis)
  assert got[0].dtype == torch.float32 and got[0].shape == shape
  assert got[1].shape == (b, c) and got[2].shape == (b, c)
  for g, w, name in zip(got, want, ('dx', 'dscale', 'doffset')):
    assert _rel(g.numpy(), w) <= F32_RTOL, name


@pytest.mark.parametrize('batch_axis', [0, 1])
def test_plain_backward_matches_jax_bf16(batch_axis):
  b, rows, c = 2, 300, 256
  shape = (b, rows, c) if batch_axis == 0 else (rows, b, c)
  x, dy, scale, offset = _inputs(shape, b, c, seed=5, dtype=jnp.bfloat16)
  want = _jax_vjp(x, dy, scale, offset, batch_axis, jnp.bfloat16)
  got = ln_film.ln_film_bwd_plain(
      torch.as_tensor(x).bfloat16(), torch.as_tensor(dy).bfloat16(),
      torch.as_tensor(scale).bfloat16(), batch_axis)
  assert got[0].dtype == torch.bfloat16
  # dx: both compute in f32 from the same bf16 inputs and round once to
  # bf16, so at most one bf16 ulp (2^-8 relative) apart. dscale/doffset:
  # f32 sums, which the reference rounds to scale's bf16 dtype.
  np.testing.assert_allclose(got[0].float().numpy(), want[0], rtol=2 ** -7,
                             atol=1e-6)
  for g, w in zip(got[1:], want[1:]):
    np.testing.assert_allclose(g.numpy(), w, rtol=2 ** -7, atol=1e-3)


def test_function_gradcheck_float64():
  """The Function's backward (the plain version on CPU) against numerical
  derivatives, in float64, in both layouts."""
  g = torch.Generator().manual_seed(0)
  for batch_axis, shape in ((0, (2, 5, 32)), (1, (7, 2, 32))):
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 2
    scale = 1 + 0.1 * torch.randn(2, 32, generator=g, dtype=torch.float64)
    offset = 0.1 * torch.randn(2, 32, generator=g, dtype=torch.float64)
    for t in (x, scale, offset):
      t.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, s, o, ax=batch_axis: ln_film.ln_film(a, s, o, ax),
        (x, scale, offset))


def test_condmlp_forward_unchanged_and_gradients_reach_film():
  """CondMLP's forward through the op keeps the unfused op order exactly
  (serving numbers do not move), and the FiLM linear gets its gradient."""
  rng = torch.Generator().manual_seed(1)
  net = mlp.CondMLP(20, 64, 1, 64, torch.nn.functional.silu, rng=rng)
  with torch.no_grad():
    net.film.linear.weight.normal_(generator=rng)
  x = torch.randn(50, 2, 20, generator=rng)
  cond = torch.randn(2, 16, generator=rng)
  got = net(x, cond)
  # The unfused composition the port served with before the op existed.
  h = net.network(x)
  scale_minus_one, offset = net.film.linear(cond[None]).chunk(2, dim=-1)
  want = ln_film.layer_norm_f32(h) * (scale_minus_one + 1.0) + offset
  assert torch.equal(got, want)
  got.square().sum().backward()
  assert net.film.linear.weight.grad.abs().sum() > 0
  assert ln_film.KERNEL.launches == 0


def test_kernel_wrapper_rejects_cpu_tensors():
  x = torch.zeros(4, 1, 64)
  with pytest.raises(ValueError, match='must be contiguous'):
    ln_film.ln_film_bwd_cuda(x, x, torch.ones(1, 64), 1)
  assert ln_film.KERNEL.launches == 0
