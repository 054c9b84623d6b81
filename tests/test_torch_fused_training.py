"""The port's training step with the fused attention backward
(GENCAST_SPARSE_FUSED_BWD=1) against the JAX package's, on CPU.

The same TINY setup as tests/test_torch_training.py (d_model 128,
block-sparse attention at tile 32, aggregation plans), with the flag on
both sides: the JAX transformer hands its attention the gather map, so
its VJP runs the interpreted Pallas `_dkvq_kernel`; the port's transformer
keeps the map as buffers and its backward runs kernel G's plain version.
The tolerances are test_torch_training.py's.
"""

import numpy as np
import pytest

from gencast_tpu.ops import sparse_attention as jax_sa
from gencast_tpu_torch.ops import sparse_attention
from tests.test_torch_training import (_check_loss_and_gradients,
                                       _check_three_adamw_steps, _pair,
                                       setup)  # noqa: F401 (fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def fused(monkeypatch):
  """The flag on both sides, and a count of the port's plain G and F
  backward calls."""
  monkeypatch.setattr(jax_sa, '_FUSED_BWD', True)
  monkeypatch.setenv('GENCAST_SPARSE_FUSED_BWD', '1')
  monkeypatch.setenv('GENCAST_FUSED_LN_FILM', '1')
  calls = {'G': 0, 'F': 0}

  def count(name, fn):
    def wrapped(*args, **kwargs):
      calls[name] += 1
      return fn(*args, **kwargs)
    return wrapped
  monkeypatch.setattr(sparse_attention, 'sparse_attention_dkvq_plain',
                      count('G', sparse_attention.sparse_attention_dkvq_plain))
  monkeypatch.setattr(sparse_attention, 'sparse_attention_bwd_plain',
                      count('F', sparse_attention.sparse_attention_bwd_plain))
  return calls


def test_both_sides_take_the_fused_backward(setup, fused):
  jmodel, _, tmodel, _ = _pair(setup, 'save_attention')
  processor = tmodel.denoiser.architecture.processor
  assert processor.operand_names[-2:] == ('slot_ids', 'valid')
  plan = setup['statics'].attention_tile_plan
  np.testing.assert_array_equal(processor.slot_ids.numpy(),
                                jax_sa.build_bwd_gather(plan)[0])
  # The JAX transformer holds the plan's five arrays and the gather map.
  jprocessor = jmodel.denoiser.architecture.processor
  assert len(jprocessor.attn_operands) == 7


def test_fused_loss_and_gradients_match_jax(setup, fused):
  _check_loss_and_gradients(setup, 'save_attention', 'pallas')
  # One fused backward per layer ('save_attention' keeps the attention
  # half), and never the split one.
  assert fused == {'G': 2, 'F': 0}


def test_fused_three_adamw_steps_match_optax(setup, fused):
  _check_three_adamw_steps(setup, 'pallas')
  assert fused['G'] == 3 * 2 and fused['F'] == 0
