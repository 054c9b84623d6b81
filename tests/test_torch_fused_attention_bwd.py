"""Kernel G's plain version (the fused block-sparse attention backward) and
its gather map against the JAX package, on CPU.

The JAX `sparse_banded_attention` custom VJP takes its fused path
(`_sba_bwd_fused`, the Pallas `_dkvq_kernel` in interpret mode) when it is
handed four backward arrays: the reverse plan and `build_bwd_gather`'s
(slot_ids, valid). The port's autograd Function takes kernel G's plain
version on CPU tensors when it gets the same gather map. Plans here have
pad slots (rows of the reverse plan shorter than its width) and rows
without any allowed key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.ops import sparse_attention as jax_sa
from gencast_tpu_torch import configs
from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.ops import sparse_attention
from tests.test_torch_attention_bwd import _mask
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# max|port - jax| / max|jax| per gradient, float32: online vs two-pass
# softmax and another summation order.
F32_RTOL = 1e-5
# bf16 inputs: both sides round w, ds and each pair's dq partial to bf16 at
# the same places (same tile), but JAX's forward (o, lse) and the port's
# differ by bf16 roundings, which a flipped rounding of an operand carries
# into a gradient entry: about one bf16 ulp (2^-8) of the largest entry.
BF16_RTOL = 2e-2


def _plan_tensors(plan):
  return tuple(torch.as_tensor(a) for a in (
      plan.mask_tiles, plan.fwd_kv_ids, plan.fwd_pair_ids, plan.bwd_q_ids,
      plan.bwd_pair_ids))


def _gather_tensors(plan):
  return tuple(torch.as_tensor(a) for a in plans.build_bwd_gather(plan))


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


def _pad_slots(plan):
  return int((plan.bwd_pair_ids == plan.num_pairs).sum())


@pytest.mark.parametrize('case', ['tile16', 'tile32', 'tiny_statics'])
def test_build_bwd_gather_equals_jax(case):
  if case == 'tiny_statics':
    spec = configs.TINY_PALLAS
    lat, lon = jax_configs.grid_for_resolution(spec.resolution_deg)
    jplan = jax_compiler.build_graph_statics(
        spec.mesh_splits, lat, lon, attention_k_hop=spec.attention_k_hop,
        attention_tile_size=spec.attention_tile_size,
        cache_dir=None).attention_tile_plan
    tplan = configs.build_statics(spec).attention_tile_plan
  else:
    tile = int(case[len('tile'):])
    mask = _mask(150, 30, seed=tile, empty_rows=(5, 149))
    jplan = jax_sa.build_tile_plan(mask, tile=tile)
    tplan = plans.build_tile_plan(mask, tile=tile)
  assert _pad_slots(tplan) > 0
  want, got = jax_sa.build_bwd_gather(jplan), plans.build_bwd_gather(tplan)
  for w, g in zip(want, got):
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def _jax_fused_grads(plan, q, k, v, dout, dtype):
  slot, valid = jax_sa.build_bwd_gather(plan)

  def f(q, k, v):
    return jax_sa.sparse_banded_attention(
        q, k, v, jnp.asarray(plan.mask_tiles), jnp.asarray(plan.fwd_kv_ids),
        jnp.asarray(plan.fwd_pair_ids),
        (jnp.asarray(plan.bwd_q_ids), jnp.asarray(plan.bwd_pair_ids),
         jnp.asarray(slot), jnp.asarray(valid)),
        (plan.tile, plan.num_active_fwd, plan.num_active_bwd))
  args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
  _, vjp = jax.vjp(f, *args)
  return [np.asarray(g.astype(jnp.float32))
          for g in vjp(jnp.asarray(dout).astype(dtype))]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_fused_backward_matches_jax(dtype):
  """The port's fused backward (plain G and its dq reduce) against
  jax.vjp through the reference's fused path, at the same tile (so the
  per-pair rounding of the partials falls at the same places in bf16)."""
  n, heads, d, tile = 100, 2, 32, 32
  mask = _mask(n, 20, seed=n, empty_rows=(3, n - 2))
  jplan = jax_sa.build_tile_plan(mask, tile=tile)
  tplan = plans.build_tile_plan(mask, tile=tile)
  rng = np.random.default_rng(1)
  q, k, v, dout = (rng.standard_normal((2, n, heads, d)).astype(np.float32)
                   for _ in range(4))
  want = _jax_fused_grads(jplan, q, k, v, dout, getattr(jnp, dtype))

  tdtype = getattr(torch, dtype)
  tq, tk, tv = (torch.tensor(x).to(tdtype).requires_grad_()
                for x in (q, k, v))
  out = sparse_attention.sparse_banded_attention(
      tq, tk, tv, *_plan_tensors(tplan)[:3], tile,
      *_plan_tensors(tplan)[3:], *_gather_tensors(tplan))
  out.backward(torch.as_tensor(dout).to(tdtype))
  rtol = F32_RTOL if dtype == 'float32' else BF16_RTOL
  for name, t, w in zip(('dq', 'dk', 'dv'), (tq, tk, tv), want):
    assert t.grad.dtype == tdtype, name
    assert _rel(t.grad.float().numpy(), w) <= rtol, name
  # A row without keys has zero dq.
  assert torch.all(tq.grad[:, 3] == 0)
  assert sparse_attention.KERNEL_DKVQ.launches == 0


def test_plain_fused_against_plain_split():
  """Plain G against plain F on the same residuals: dk and dv are the same
  float32 arithmetic (exactly equal); dq sums the same products by pair."""
  n, tile = 150, 24
  plan = plans.build_tile_plan(_mask(n, 45, seed=2, empty_rows=(7,)),
                               tile=tile)
  assert _pad_slots(plan) > 0
  mt, fi, fp, bi, bp = _plan_tensors(plan)
  g = torch.Generator().manual_seed(0)
  q, k, v, dout = (torch.randn(2, n, 4, 16, generator=g) for _ in range(4))
  o, lse = sparse_attention.sparse_banded_attention_plain(
      q, k, v, mt, fi, fp, tile, return_lse=True)
  delta = sparse_attention.attention_delta(o, dout)
  args = (q, k, v, dout, lse, delta, mt, bi, bp, tile)
  dk, dv, partial = sparse_attention.sparse_attention_dkvq_plain(*args)
  assert partial.shape == (2, plan.num_q_tiles * plan.num_active_bwd, 4,
                           tile, 16)
  want_dk, want_dv = sparse_attention.sparse_attention_dkv_plain(*args)
  assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
  dq = sparse_attention.sparse_attention_dq_reduce(
      partial, *_gather_tensors(plan), n)
  want_dq = sparse_attention.sparse_attention_dq_plain(
      q, k, v, dout, lse, delta, mt, fi, fp, tile)
  torch.testing.assert_close(dq, want_dq, rtol=0,
                             atol=1e-6 * float(want_dq.abs().max()))


def test_dq_reduce_never_reads_pad_slots():
  """Kernel G leaves the slots of pad pairs unwritten: the reduce selects
  them away (and the forward plan's pad entries, which point at slot 0),
  so NaN there never reaches dq."""
  n, tile = 150, 24
  plan = plans.build_tile_plan(_mask(n, 45, seed=2), tile=tile)
  g = torch.Generator().manual_seed(1)
  slot_ids, valid = _gather_tensors(plan)
  partial = torch.randn(1, plan.num_q_tiles * plan.num_active_bwd, 2, tile,
                        8, generator=g)
  want = sparse_attention.sparse_attention_dq_reduce(partial, slot_ids,
                                                     valid, n)
  pads = torch.as_tensor(plan.bwd_pair_ids.reshape(-1) == plan.num_pairs)
  assert pads.any() and bool(valid.eq(0).any())
  partial[:, pads] = float('nan')
  got = sparse_attention.sparse_attention_dq_reduce(partial, slot_ids, valid,
                                                    n)
  assert torch.isfinite(got).all()
  assert torch.equal(got, want)


def test_fused_backward_gradcheck_float64():
  """The fused backward against numerical derivatives (float64), with a
  padded last tile, pad slots and a row without keys."""
  n, tile = 21, 8
  plan = plans.build_tile_plan(_mask(n, 4, seed=0, empty_rows=(6,)),
                               tile=tile)
  tensors = _plan_tensors(plan) + _gather_tensors(plan)
  mt, fi, fp, bi, bp, slot_ids, valid = tensors
  g = torch.Generator().manual_seed(3)
  q, k, v = (torch.randn(1, n, 2, 4, generator=g, dtype=torch.float64,
                         requires_grad=True) for _ in range(3))

  def f(q, k, v):
    return sparse_attention.sparse_banded_attention(
        q, k, v, mt, fi, fp, tile, bi, bp, slot_ids, valid)
  assert torch.autograd.gradcheck(f, (q, k, v))


def test_fused_wrapper_rejects_cpu_tensors():
  plan = plans.build_tile_plan(_mask(64, 8, seed=4), tile=64)
  mt, _, _, bi, bp = _plan_tensors(plan)
  q = torch.zeros(1, 64, 2, 32)
  lse = torch.zeros(1, 2, 64)
  with pytest.raises(ValueError, match='must be on'):
    sparse_attention.sparse_attention_dkvq_cuda(q, q, q, q, lse, lse, mt, bi,
                                                bp, 64)
  assert sparse_attention.KERNEL_DKVQ.launches == 0


def test_transformer_holds_the_gather_map_only_under_the_flag(monkeypatch):
  spec = dataclasses.replace(configs.TINY_PALLAS, num_layers=1)
  statics = configs.build_statics(spec)
  monkeypatch.delenv('GENCAST_SPARSE_FUSED_BWD', raising=False)
  plain, _ = configs.build_gencast(spec, statics=statics, device='cpu')
  monkeypatch.setenv('GENCAST_SPARSE_FUSED_BWD', '1')
  fused, _ = configs.build_gencast(spec, statics=statics, device='cpu')
  buffers = [dict(m.denoiser.architecture.processor.named_buffers())
             for m in (plain, fused)]
  assert 'slot_ids' not in buffers[0] and 'valid' not in buffers[0]
  want = plans.build_bwd_gather(statics.attention_tile_plan)
  for name, w in zip(('slot_ids', 'valid'), want):
    np.testing.assert_array_equal(buffers[1][name].numpy(), w)
  # Not part of the state: checkpoints of either variant load in the other.
  assert plain.state_dict().keys() == fused.state_dict().keys()
