"""Runs one cell of the benchmark of gencast_tpu_torch on this machine's
CUDA cards and prints its result as the last line of standard output.

    python3 perfbench/run.py --workload gencast_1p0deg.forecast_m8 \
        --seed 12345 --seconds 40 --trace 0

See perfbench/README.md.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.lib import harness  # noqa: E402

if __name__ == '__main__':
  sys.exit(harness.main(sys.argv[1:], STARTED))
