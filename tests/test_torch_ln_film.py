"""The LN+FiLM op's plain versions against the JAX package: kernel E's
(the backward) and the forward's, whose op order is the forward kernel's
contract.

The JAX `ln_film` custom VJP runs its Pallas backward in interpret mode on
the CPU, as tests/test_ln_film.py runs it; its forward is plain XLA
(`ln_film_reference`). The port's autograd Function takes the plain
versions on CPU tensors; the CUDA kernels run only on the card, where
chip_smoke.py holds them against these same plain versions. Here: the
wrappers' checks, their grids' row partitions, and the kernels' launches
per denoiser call and training step that chip_smoke.py derives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gencast_tpu.ops import ln_film as jax_lf
from gencast_tpu_torch import configs
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.nn import mlp
from gencast_tpu_torch.ops import ln_film
from gencast_tpu_torch.training import steps
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# float32: the same f32 formulas in another summation order; relative to
# the largest magnitude of each gradient.
F32_RTOL = 1e-5
# The forward in float32 against XLA's: the same op order, the two means
# summed in another order (2e-7 of the largest output at these inputs).
FWD_F32_RTOL = 1e-6


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_wrapper_rejects_misaligned_rows(dtype):
  """The kernel loads and stores rows in 16-byte vectors."""
  flat = torch.zeros(4 * 64 + 1, dtype=dtype)
  x = flat[1:].view(4, 1, 64)  # 2 or 4 bytes past 16
  with pytest.raises(ValueError, match='x starts at address'):
    ln_film.ln_film_bwd_cuda(x, torch.zeros(4, 1, 64, dtype=dtype),
                             torch.ones(1, 64, dtype=dtype), 1)
  assert ln_film.KERNEL.launches == 0


@pytest.mark.parametrize('c', [36, 48, 1056])
def test_kernel_wrapper_rejects_channels_it_does_not_vectorize(c):
  """C must be a multiple of 32 (so of the 8 bf16 or 4 float32 of a 16-byte
  vector) up to 1024."""
  x = torch.zeros(4, 1, c, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match='multiple of 32'):
    ln_film.ln_film_bwd_cuda(x, x, torch.ones(1, c, dtype=torch.bfloat16), 1)
  with pytest.raises(TypeError, match='float32 or bfloat16'):
    ln_film.ln_film_bwd_cuda(x.half(), x.half(), torch.ones(1, c).half(), 1)
  assert ln_film.KERNEL.launches == 0


# Every shape the 1-degree and nano training steps give kernel E (rows,
# batch), both layouts at batch 2, and TINY's; resident blocks as on an H100
# SXM (132 SMs) at 1-3 blocks per SM and on an H100 PCIe (114 SMs).
_SHAPES = [(10304, 1), (10242, 1), (65160, 1), (101892, 1), (195480, 1),
           (2624, 1), (2562, 1), (10304, 2), (10242, 2), (162, 2), (0, 1),
           (7, 1)]


@pytest.mark.parametrize('rows, batch', _SHAPES)
@pytest.mark.parametrize('resident, sms', [(132, 132), (264, 132),
                                           (396, 132), (228, 114)])
def test_launch_partition_covers_every_row_once(rows, batch, resident, sms):
  blocks = ln_film.launch_blocks(rows, batch, resident, sms)
  assert 1 <= blocks and batch * blocks <= resident
  taken = np.zeros(rows, np.int64)
  for r in ln_film.warp_rows(rows, blocks):
    taken[list(r)] += 1
  assert (taken == 1).all()
  # No block without a row, unless there are fewer rows than one block's
  # warps.
  assert blocks == 1 or (blocks - 1) * 8 < rows


def test_launch_needs_a_block_per_batch_element():
  with pytest.raises(ValueError, match='resident'):
    ln_film.launch_blocks(100, 4, 3, 3)


def _bf16_within_one_step(got, want, x, scale, batch_axis):
  """(share of got's elements with want's bits, max |got - want| over one
  bf16 rounding step at the element's magnitude, eps * (|want| + |scale|
  (|x_hat| + 1)), the allowance chip_smoke.py gives the forward kernel)."""
  got, want = got.float(), want.float()
  x32 = x.float()
  mu, rstd = ln_film._mean_rstd(x32, ln_film.EPS)
  per_batch = scale[None] if batch_axis == 1 else scale[:, None]
  step = torch.finfo(torch.bfloat16).eps * (
      want.abs() + per_batch.float().abs() * (((x32 - mu) * rstd).abs() + 1))
  return (float((got == want).float().mean()),
          float(((got - want).abs() / step).max()))


@pytest.mark.parametrize('batch_axis', [0, 1])
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_plain_forward_matches_jax_reference(dtype, batch_axis):
  """The forward's op order, which the forward kernel keeps bit for bit
  (its float32 sums apart): one-pass variance clamped at 0, x_hat rounded
  to x's dtype, the FiLM multiply and add each in that dtype, as the JAX
  package's ln_film_reference."""
  b, rows, c = 2, 700, 256
  shape = (b, rows, c) if batch_axis == 0 else (rows, b, c)
  x, _, scale, offset = _inputs(shape, b, c, seed=11, dtype=getattr(
      jnp, dtype))
  tdt = getattr(torch, dtype)
  xt, st, ot = (torch.as_tensor(a).to(tdt) for a in (x, scale, offset))
  got = ln_film.ln_film_forward(xt, st, ot, batch_axis)
  assert got.dtype == tdt and got.shape == shape
  sh = (1, b, c) if batch_axis == 1 else (b, 1, c)
  jd = getattr(jnp, dtype)
  want = jax_lf.ln_film_reference(jnp.asarray(x, jd),
                                  jnp.asarray(scale, jd).reshape(sh),
                                  jnp.asarray(offset, jd).reshape(sh))
  want = torch.as_tensor(np.array(want, np.float32)).to(tdt)
  if tdt == torch.bfloat16:
    share, steps_ = _bf16_within_one_step(got, want, xt, st, batch_axis)
    assert share >= chip_smoke.FWD_BITWISE_SHARE and steps_ <= 1
  else:
    assert _rel(got.numpy(), want.numpy()) <= FWD_F32_RTOL


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_lane_order_yardstick_keeps_the_plain_op_order(dtype):
  """chip_smoke.py holds the forward kernel bitwise to the plain op order
  summed in the kernel's lane order (ln_film_fwd_lane_order); that
  yardstick differs from the plain version only as the kernel may."""
  g = torch.Generator().manual_seed(3)
  for shape, axis in (((300, 2, 512), 1), ((2, 150, 64), 0),
                      ((40, 1, 1024), 1)):
    x, scale, offset = chip_smoke.ln_film_fwd_inputs(shape, axis, dtype, g)
    got = chip_smoke.ln_film_fwd_lane_order(x, scale, offset, axis)
    want = ln_film.ln_film_forward(x, scale, offset, axis)
    assert got.dtype == dtype and got.shape == shape
    if dtype == torch.bfloat16:
      share, steps_ = _bf16_within_one_step(got, want, x, scale, axis)
      assert share >= chip_smoke.FWD_BITWISE_SHARE and steps_ <= 1
    else:
      ref = ln_film.ln_film_forward(x.double(), scale.double(),
                                    offset.double(), axis)
      plain_err = float((want.double() - ref).abs().max())
      assert (float((got.double() - ref).abs().max())
              <= chip_smoke.FWD_F32_ERR_RATIO * plain_err)


def test_cpu_tensors_take_the_plain_forward():
  """On CPU tensors the op's forward is ln_film_forward, bit for bit, and
  the forward kernel's counter does not move; so does a CondMLP's."""
  g = torch.Generator().manual_seed(4)
  for shape, axis in (((50, 2, 64), 1), ((2, 30, 64), 0)):
    for dtype in (torch.float32, torch.bfloat16):
      x, scale, offset = chip_smoke.ln_film_fwd_inputs(shape, axis, dtype, g)
      want = ln_film.ln_film_forward(x, scale, offset, axis)
      assert torch.equal(ln_film.ln_film(x, scale, offset, axis), want)
      assert torch.equal(ln_film.ln_film_fwd(x, scale, offset, axis), want)
  net = mlp.CondMLP(20, 64, 1, 64, torch.nn.functional.silu, rng=g)
  net(torch.randn(50, 2, 20, generator=g), torch.randn(2, 16, generator=g))
  assert ln_film.KERNEL_FWD.launches == 0


def test_forward_kernel_wrapper_rejects_cpu_tensors():
  x = torch.zeros(4, 1, 64)
  with pytest.raises(ValueError, match='must be contiguous'):
    ln_film.ln_film_fwd_cuda(x, torch.ones(1, 64), torch.zeros(1, 64), 1)
  assert ln_film.KERNEL_FWD.launches == 0


@pytest.mark.parametrize('operand', ['x', 'scale', 'offset'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_forward_kernel_wrapper_rejects_misaligned_rows(dtype, operand):
  """The kernel loads x, scale and offset and stores y in 16-byte
  vectors."""
  shapes = {'x': (4, 1, 64), 'scale': (1, 64), 'offset': (1, 64)}
  args = {name: torch.zeros(shape, dtype=dtype)
          for name, shape in shapes.items()}
  flat = torch.zeros(args[operand].numel() + 1, dtype=dtype)
  args[operand] = flat[1:].view(shapes[operand])  # 2 or 4 bytes past 16
  with pytest.raises(ValueError, match=f'{operand} starts at address'):
    ln_film.ln_film_fwd_cuda(args['x'], args['scale'], args['offset'], 1)
  assert ln_film.KERNEL_FWD.launches == 0


@pytest.mark.parametrize('c', [36, 48, 1056])
def test_forward_kernel_wrapper_rejects_channels_it_does_not_vectorize(c):
  x = torch.zeros(4, 1, c, dtype=torch.bfloat16)
  per_batch = torch.ones(1, c, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match='multiple of 32'):
    ln_film.ln_film_fwd_cuda(x, per_batch, per_batch, 1)
  with pytest.raises(TypeError, match='float32 or bfloat16'):
    ln_film.ln_film_fwd_cuda(x.half(), per_batch.half(), per_batch.half(),
                             1)
  assert ln_film.KERNEL_FWD.launches == 0


@pytest.mark.parametrize('operand', ['scale', 'offset'])
def test_forward_kernel_wrapper_rejects_mixed_dtypes(operand):
  """x, scale and offset of one dtype: the kernel reads all three as x's
  (every path of the model gives it so: the conditioning is cast to the
  activations' dtype)."""
  args = {'x': torch.zeros(4, 1, 64, dtype=torch.bfloat16),
          'scale': torch.ones(1, 64, dtype=torch.bfloat16),
          'offset': torch.zeros(1, 64, dtype=torch.bfloat16)}
  args[operand] = args[operand].float()
  with pytest.raises(ValueError, match=f'{operand} is torch.float32'):
    ln_film.ln_film_fwd_cuda(args['x'], args['scale'], args['offset'], 1)
  assert ln_film.KERNEL_FWD.launches == 0


@pytest.mark.parametrize('rows, batch', _SHAPES + [(195480, 8), (10304, 8),
                                                   (41024, 1)])
@pytest.mark.parametrize('resident', [132, 396, 528, 228])
def test_forward_launch_partition_covers_every_row_once(rows, batch,
                                                        resident):
  """The forward kernel's grid: at most its waves of the resident blocks
  (one a batch element at least), no warp without a row unless a block has
  more warps than rows, and every row taken once by its warps' stride."""
  blocks = ln_film.launch_blocks_fwd(rows, batch, resident)
  assert 1 <= blocks and (
      blocks == 1 or batch * blocks <= ln_film._FWD_WAVES * resident)
  assert blocks == 1 or (blocks - 1) * 8 < rows
  taken = np.zeros(rows, np.int64)
  for r in ln_film.warp_rows(rows, blocks):
    taken[list(r)] += 1
  assert (taken == 1).all()


@pytest.mark.parametrize('case', [
    {},  # TINY's 'full' remat
    {'remat_policy': 'save_attention'},  # 1 degree's
    {'remat_gnns': True},
    {'edge_chunk_size': 64},
    {'edge_chunk_size': 100, 'remat_gnns': True,
     'remat_policy': 'save_attention'},  # 0.25 degrees' structure
    # The mesh's node MLPs in one chunk (as at 0.25 degrees), then all.
    {'edge_chunk_size': 200, 'remat_gnns': True,
     'remat_policy': 'save_attention'},
    {'edge_chunk_size': 700, 'remat_gnns': True},
])
def test_forward_launches_per_call_and_step(monkeypatch, case):
  """chip_smoke.py holds the forward kernel's launches per denoiser call
  and per training step to counts derived from the model
  (`ln_film_fwd_launches`): counted here on the CPU, where the forward's
  dispatch runs once per LN+FiLM, the backward's recomputations (remat of
  the transformer's halves, of the GNNs and of their chunks) included."""
  spec = dataclasses.replace(configs.TINY_PALLAS, **case)
  model, statics = configs.build_gencast(spec, seed=0, device='cpu')
  task = spec.task
  stats = chip_smoke.unit_stats(task)
  stack = wrappers.build_stack(model, stats, bf16=False)
  den = model.denoiser
  rng = np.random.default_rng(0)
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  batch = [torch.as_tensor(rng.standard_normal(grid + (lay.num_channels,)),
                           dtype=torch.float32)
           for lay in (den.input_layout, den.target_layout,
                       den.forcing_layout)]
  calls = []
  forward = ln_film.ln_film_fwd

  def counted(x, *rest):
    calls.append(tuple(x.shape))
    return forward(x, *rest)

  monkeypatch.setattr(ln_film, 'ln_film_fwd', counted)
  with torch.no_grad():
    den(batch[0], batch[1], torch.ones(1), batch[2])
  assert len(calls) == chip_smoke.ln_film_fwd_launches(model)
  assert len(calls) == chip_smoke.expected_step_launches(model)[
      ln_film.KERNEL.name]
  calls.clear()
  optimizer = steps.create_optimizer(stack,
                                     steps.OptimizerConfig(total_steps=10))
  steps.train_step(stack, optimizer, *batch, torch.Generator().manual_seed(1))
  assert len(calls) == chip_smoke.expected_step_launches(model)[
      ln_film.KERNEL_FWD.name]
  assert len(calls) == chip_smoke.ln_film_fwd_launches(model, train=True)
  assert ln_film.KERNEL_FWD.launches == 0
