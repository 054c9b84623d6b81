"""Kernel G's dq reduce on CPU: the entry point, its plain version, the
order of its sums, the checks of the CUDA wrapper, and the launches that
chip_smoke.py expects of the fused backward per training step.

The reduce kernel runs only on the card, where chip_smoke.py holds it
against `sparse_attention_dq_reduce_plain`; here the entry point takes the
plain version for CPU tensors and the wrapper must refuse them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from gencast_tpu_torch import configs
from gencast_tpu_torch.graph import plans
from gencast_tpu_torch.nn import transformer
from gencast_tpu_torch.ops import sparse_attention
from tests.test_torch_attention_bwd import _mask
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _partials(dtype, seed=0, n=150, tile=24, heads=2, d=8):
  """(partial [1, S, H, tile, d] with NaN in every pad slot, slot_ids,
  valid, n) of a plan with pad slots and a ragged last tile."""
  plan = plans.build_tile_plan(_mask(n, 45, seed=2, empty_rows=(7,)),
                               tile=tile)
  g = torch.Generator().manual_seed(seed)
  partial = torch.randn(1, plan.num_q_tiles * plan.num_active_bwd, heads,
                        tile, d, generator=g).to(dtype)
  pads = torch.as_tensor(plan.bwd_pair_ids.reshape(-1) == plan.num_pairs)
  assert pads.any()
  partial[:, pads] = float('nan')
  slot_ids, valid = (torch.as_tensor(a) for a in plans.build_bwd_gather(plan))
  return partial, slot_ids, valid, n


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_entry_point_takes_the_plain_reduce_on_cpu(dtype):
  args = _partials(dtype)
  got = sparse_attention.sparse_attention_dq_reduce(*args)
  want = sparse_attention.sparse_attention_dq_reduce_plain(*args)
  assert got.dtype == dtype and got.shape == (1, args[3], 2, 8)
  assert torch.isfinite(got).all()
  assert torch.equal(got, want)
  assert sparse_attention.KERNEL_DQ_REDUCE.launches == 0


def test_float32_reduce_sums_in_slot_order():
  """The plain reduce against a numpy loop that adds each q tile's valid
  partials in float32 in slot order a = 0, 1, ... (the order of the
  kernel's sums), then scales: within 1e-6 of the largest entry."""
  partial, slot_ids, valid, n = _partials(torch.float32, seed=3)
  p = partial.numpy()
  b, _, h, tile, d = p.shape
  nq, num_active = slot_ids.shape
  dq = np.zeros((b, nq, tile, h, d), np.float32)
  for qi in range(nq):
    acc = np.zeros((b, h, tile, d), np.float32)
    for a in range(num_active):
      if valid[qi, a] != 0:
        acc = acc + p[:, int(slot_ids[qi, a])]
    dq[:, qi] = (acc * np.float32(d ** -0.5)).transpose(0, 2, 1, 3)
  want = dq.reshape(b, nq * tile, h, d)[:, :n]
  got = sparse_attention.sparse_attention_dq_reduce_plain(
      partial, slot_ids, valid, n).numpy()
  assert np.isfinite(want).all()
  assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _bad_operands(case):
  partial, slot_ids, valid, n = _partials(torch.float32, d=32)
  if case == 'float16':
    partial = partial.half()
  elif case == 'slot_ids_shape':
    slot_ids = slot_ids[:, :-1].contiguous()
  elif case == 'valid_shape':
    valid = valid[:-1]
  return partial, slot_ids, valid, n


@pytest.mark.parametrize('case, error, match', [
    ('cpu', ValueError, 'CUDA'),
    ('float16', TypeError, 'float32 or bfloat16'),
    ('slot_ids_shape', ValueError, 'valid must be'),
    ('valid_shape', ValueError, 'valid must be'),
])
def test_cuda_reduce_refuses_what_the_kernel_does_not_take(case, error,
                                                            match):
  with pytest.raises(error, match=match):
    sparse_attention.sparse_attention_dq_reduce_cuda(*_bad_operands(case))
  assert sparse_attention.KERNEL_DQ_REDUCE.launches == 0


@pytest.mark.parametrize('fused', [False, True])
def test_step_launches_of_the_fused_backward(monkeypatch, fused):
  """chip_smoke's launches per training step: under the flag G and its
  reduce once per layer each and F never; without it F's two kernels once
  per layer each and the reduce never."""
  spec = dataclasses.replace(configs.TINY, num_layers=2,
                             remat_policy='save_attention')  # 1 degree's
  if fused:
    monkeypatch.setenv(transformer.FUSED_BWD_ENV, '1')
  else:
    monkeypatch.delenv(transformer.FUSED_BWD_ENV, raising=False)
  model, _ = configs.build_gencast(spec, device='cpu')
  launches = chip_smoke.expected_step_launches(model)
  sa = sparse_attention
  want = {sa.KERNEL_DKVQ: 2 if fused else 0,
          sa.KERNEL_DQ_REDUCE: 2 if fused else 0,
          sa.KERNEL_DQ: 0 if fused else 2,
          sa.KERNEL_DKV: 0 if fused else 2,
          sa.KERNEL: 2}  # A once per layer: its half is not recomputed
  for counter, count in want.items():
    assert launches[counter.name] == count, counter.name
  assert set(launches) == {c.name for c in chip_smoke.counters()}
