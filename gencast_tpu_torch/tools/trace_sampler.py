"""Profile one forecast step of the sampler and print the kernel breakdown.

Counterpart of `tools/trace_sampler.py`. On one CUDA card:

    python -m gencast_tpu_torch.tools.trace_sampler [outdir] [preset]

The sampler's 2N - 1 = 39 denoiser calls per 12-hour step are the inner
loop of every forecast. `trace_qdeg.run` in `--mode sample` (1deg by
default: kernels A and B): `training/profile_step.py` profiles one forecast
step of the serving stack, each call a replay of the model's CUDA graph,
after a warm-up step that captures it, and writes the trace to
`outdir`; `trace_qdeg.parse` then prints the trace's breakdown.
"""

from __future__ import annotations

import os
import sys

from gencast_tpu_torch.tools import trace_qdeg


def main(argv=None) -> None:
  argv = sys.argv[1:] if argv is None else argv
  out = argv[0] if argv else os.path.join('build', 'trace_sampler')
  trace_qdeg.run(out, argv[1] if len(argv) > 1 else '1deg', mode='sample')
  trace_qdeg.parse(out, top=60)


if __name__ == '__main__':
  main()
