"""bf16 numerics guard: reductions such as softmax and layer-norm statistics
run in float32 even when activations are bf16.

Counterpart of `gencast_tpu.nn.precision.with_f32`. The reference also
wraps the upcast in `reduce_precision` so XLA cannot elide the cast pair;
eager PyTorch performs every cast it is given, so no guard is needed.
"""

from __future__ import annotations

from typing import Callable

import torch


def with_f32(fn: Callable[..., torch.Tensor], *inputs: torch.Tensor
             ) -> torch.Tensor:
  """Runs `fn` on float32 copies of `inputs` and casts the result back to
  the first input's dtype (a no-op wrapper for float32 inputs)."""
  dtype = inputs[0].dtype
  if dtype == torch.float32:
    return fn(*inputs)
  return fn(*(x.float() for x in inputs)).to(dtype)
