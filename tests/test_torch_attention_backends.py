"""The reference's einsum attention backends in the port, against the JAX
package on the CPU: `nn.precision` (`reduce_precision`, `with_f32`), the
'triblock' and 'dense' attention modules on bridged weights, and the TINY
preset field for field (tests/test_torch_tiny_reference.py runs the
reference's TINY and a 'dense' TINY end to end).

The einsum backends write a finite masked-softmax value into a query row
that sees no key, where the kernels write 0; only those rows' cotangents
must agree, and nothing downstream reads them (the JAX module slices its
padding off, the port's transformer slices it after the stack).
"""

import dataclasses

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.nn import precision as jax_precision
from gencast_tpu.nn import transformer as jax_transformer
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.graph import compiler
from gencast_tpu_torch.nn import precision, transformer
from gencast_tpu_torch.ops import banded_attention
from tests.test_torch_training import _flat
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# One attention module, float32: max|port - jax| / max|jax| of the output
# (summation order of the einsums), and of every input cotangent and
# parameter gradient, relative to its largest entry.
MODULE_RTOL = 1e-5
MODULE_GRAD_RTOL = 1e-4
BACKENDS = ('triblock', 'dense')


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_numpy(x):
  return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize('bits', [(8, 7), (5, 10)])
def test_reduce_precision_is_jax_bit_for_bit(bits):
  """The forward rounds as jax.lax.reduce_precision, and the VJP rounds the
  cotangent the same way (float32 in, ties, overflow, NaN)."""
  rng = np.random.default_rng(0)
  x = (rng.standard_normal(4096) * np.logspace(-3, 6, 4096)).astype(
      np.float32)
  x[:3] = [np.nan, np.inf, -np.inf]
  # Ties of either rounding, both ways: 1 + 2^-8 (bf16) and 1 + 2^-11
  # (float16) are halfway between two of the narrow format's values, and so
  # are the values one of their last bits above.
  ties = np.asarray([1 + 2.0**-8, 1 + 3 * 2.0**-8, 1 + 2.0**-11,
                     1 + 3 * 2.0**-11, 65520.0, 2.0**-15, 2.0**-14],
                    np.float32)
  x[3:3 + 2 * len(ties)] = np.concatenate([ties, -ties])
  cot = rng.standard_normal(4096).astype(np.float32) * 1e3
  want, vjp = jax.vjp(lambda t: jax_precision.reduce_precision(t, *bits),
                      jnp.asarray(x))
  (want_grad,) = vjp(jnp.asarray(cot))
  t = torch.as_tensor(x).requires_grad_()
  got = precision.reduce_precision(t, *bits)
  got.backward(torch.as_tensor(cot))
  np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
  np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want_grad))


def test_with_f32_is_jax_bit_for_bit_on_bf16():
  """with_f32 on bf16 inputs (a tuple of them): float32 arithmetic inside,
  bf16 out; forward and VJP bitwise JAX's. float32 inputs pass through."""
  rng = np.random.default_rng(1)
  xs = [_bf16_numpy(rng.standard_normal((8, 33)) * 10) for _ in range(2)]
  cots = [_bf16_numpy(rng.standard_normal((8, 33))) for _ in range(2)]

  def jfn(pair):
    a, b = pair
    return a * b + 0.1, a / 3.0

  def tfn(pair):
    a, b = pair
    return a * b + 0.1, a / 3.0

  jx = tuple(jnp.asarray(x, jnp.bfloat16) for x in xs)
  want, vjp = jax.vjp(lambda p: jax_precision.with_f32(jfn, p), jx)
  want_grads = vjp(tuple(jnp.asarray(c, jnp.bfloat16) for c in cots))[0]
  tx = tuple(torch.as_tensor(x).to(torch.bfloat16).requires_grad_()
             for x in xs)
  got = precision.with_f32(tfn, tx)
  assert all(g.dtype == torch.bfloat16 for g in got)
  torch.autograd.backward(got, [torch.as_tensor(c).to(torch.bfloat16)
                                for c in cots])
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.detach().float().numpy(),
                                  np.asarray(w.astype(jnp.float32)))
  for t, w in zip(tx, want_grads):
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  np.asarray(w.astype(jnp.float32)))
  f32 = torch.ones(3)
  assert precision.with_f32(lambda t: t, f32) is f32


@pytest.fixture(scope='module')
def tiny_statics():
  spec = configs.TINY
  lat, lon = configs.grid_for_resolution(spec.resolution_deg)
  return compiler.build_graph_statics(
      spec.mesh_splits, lat, lon, attention_k_hop=spec.attention_k_hop,
      build_triblock_mask=True, cache_dir=None)


def _module_pair(kind, statics):
  """A JAX attention module of `kind` with perturbed weights, the port's
  with the same weights, and the operands each takes."""
  spec = configs.TINY
  jcfg = jax_transformer.TransformerConfig(
      d_model=spec.d_model, num_layers=spec.num_layers,
      num_heads=spec.num_heads, ffw_hidden=spec.ffw_hidden,
      attention_type=kind)
  tcfg = transformer.TransformerConfig(
      d_model=spec.d_model, num_layers=spec.num_layers,
      num_heads=spec.num_heads, ffw_hidden=spec.ffw_hidden,
      attention_type=kind)
  if kind == 'triblock':
    mask = statics.attention_mask
    padded = mask.num_blocks * mask.block_size
    jmod = jax_transformer.TriblockAttention(jcfg, mask.block_size, padded,
                                             rngs=nnx.Rngs(0))
    tmod = transformer.TriblockAttention(
        tcfg, mask.block_size, rng=torch.Generator().manual_seed(0))
    blocks = mask.blocks
  else:
    padded = statics.num_mesh_nodes
    jmod = jax_transformer.DenseAttention(jcfg, rngs=nnx.Rngs(0))
    tmod = transformer.DenseAttention(tcfg,
                                      rng=torch.Generator().manual_seed(0))
    blocks = configs.dense_attention_mask(statics, spec.attention_k_hop)
  flat_state = nnx.to_flat_state(nnx.state(jmod, nnx.Param))
  flat = bridge.perturbed(_flat(nnx.state(jmod, nnx.Param)), seed=3)
  nnx.update(jmod, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in flat_state]))
  bridge.load_reference_params(tmod, flat)
  return jmod, tmod, blocks, padded


@pytest.mark.parametrize('kind', BACKENDS)
def test_attention_module_matches_jax(kind, tiny_statics):
  """Output, input cotangent and parameter gradients of one attention
  module (batch 2, TINY's 162 mesh nodes) against the JAX module's on the
  same weights; the port's tri-block input carries the transformer's
  padding (zero rows), which the JAX module adds itself."""
  jmod, tmod, blocks, padded = _module_pair(kind, tiny_statics)
  n = tiny_statics.num_mesh_nodes
  rng = np.random.default_rng(2)
  x = rng.standard_normal((2, n, configs.TINY.d_model)).astype(np.float32)
  cot = rng.standard_normal(x.shape).astype(np.float32)
  args = (jnp.asarray(blocks),)

  def jloss(m, xx):
    return (m(xx, args) * jnp.asarray(cot)).sum()

  want = np.asarray(jmod(jnp.asarray(x), args))
  jgrad_m, jgrad_x = nnx.grad(jloss, argnums=(0, 1))(jmod, jnp.asarray(x))
  xt = torch.as_tensor(np.pad(x, ((0, 0), (0, padded - n), (0, 0))))
  xt.requires_grad_()
  got = tmod(xt, (torch.as_tensor(blocks),))[:, :n]
  (got * torch.as_tensor(cot)).sum().backward()
  assert got.shape == want.shape
  assert _rel(got.detach().numpy(), want) <= MODULE_RTOL
  assert _rel(xt.grad[:, :n].numpy(), np.asarray(jgrad_x)) <= MODULE_GRAD_RTOL
  jg = _flat(jgrad_m)
  tg = bridge.export_reference_grads(tmod)
  assert sorted(tg) == sorted(jg) and len(jg) == 5
  for k, w in jg.items():
    assert _rel(tg[k], w) <= MODULE_GRAD_RTOL, k


def test_triblock_masked_rows_differ_only_where_nothing_reads_them(
    tiny_statics):
  """A padded query row (no key) gets the einsum path's finite masked-
  softmax value, where kernel C's plain version writes 0; the real rows
  agree and a cotangent on the real rows alone gives both the same input
  gradients."""
  _, tmod, blocks, padded = _module_pair('triblock', tiny_statics)
  n = tiny_statics.num_mesh_nodes
  rng = np.random.default_rng(5)
  x = torch.as_tensor(rng.standard_normal(
      (1, padded, configs.TINY.d_model)).astype(np.float32))
  mask = torch.as_tensor(blocks)
  bs = tiny_statics.attention_mask.block_size

  def plain(xx):
    q, k, v = tmod.proj.split_heads(xx)
    o = banded_attention.banded_attention_plain(q, k, v,
                                                mask.to(torch.uint8), bs)
    return tmod.proj.out(o.reshape(o.shape[:2] + (-1,)))

  outs, grads = [], []
  for fn in (lambda xx: tmod(xx, (mask,)), plain):
    xx = x.clone().requires_grad_()
    out = fn(xx)
    out[:, :n].sum().backward()
    outs.append(out.detach())
    grads.append(xx.grad)
  assert _rel(outs[0][:, :n].numpy(), outs[1][:, :n].numpy()) <= MODULE_RTOL
  assert torch.isfinite(outs[0]).all()
  # The padded rows: the kernel's 0 (through the output projection's bias)
  # against the einsum path's value.
  bias = tmod.proj.out.bias.detach()
  assert torch.equal(outs[1][0, n:], bias.expand(padded - n, -1))
  assert not torch.allclose(outs[0][0, n:], outs[1][0, n:])
  assert _rel(grads[0].numpy(), grads[1].numpy()) <= MODULE_GRAD_RTOL


def test_tiny_preset_is_the_references_field_for_field():
  """SPECS['tiny'] is jax_configs.TINY: every field both ModelSpecs have
  is equal (the task's too). Port-only: agg_plan_min_degree (the planned
  aggregation's gate, off at TINY). Reference-only: use_gradient_
  checkpointing (the port recomputes whenever gradients are recorded),
  scan_unroll (the port's layer stack is a Python loop) and
  use_donated_step (TPU-only)."""
  port, ref = configs.SPECS['tiny'], jax_configs.TINY
  port_fields = {f.name for f in dataclasses.fields(port)}
  ref_fields = {f.name for f in dataclasses.fields(ref)}
  assert port_fields - ref_fields == {'agg_plan_min_degree'}
  assert ref_fields - port_fields == {'use_gradient_checkpointing',
                                      'scan_unroll', 'use_donated_step'}
  for name in sorted(port_fields & ref_fields):
    a, b = getattr(port, name), getattr(ref, name)
    if name == 'task':
      a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    assert a == b, name
  assert ref.use_gradient_checkpointing and ref.remat_policy == 'full'
  assert port.attention_type == 'triblock' and port.cast_bf16 is False
  # The kernels' variants differ from it in the backend (and the tile).
  for variant, kind in ((configs.TINY_PALLAS, 'pallas'),
                        (configs.TINY_TRIBLOCK, 'triblock_pallas')):
    assert variant.attention_type == kind
    assert dataclasses.replace(variant, name='tiny', attention_type='triblock',
                               attention_tile_size=512) == port
