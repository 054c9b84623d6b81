"""gencast_tpu_torch: the PyTorch/CUDA port of gencast_tpu for NVIDIA Hopper.

The JAX package `gencast_tpu` is the reference; this package mirrors its
module paths and names. It imports torch, numpy and scipy only. Host-side
numpy code (registry, layout tables, graph compiler, plan construction) is
carried over rather than imported, because importing any `gencast_tpu`
submodule imports jax and flax.

Device work runs eagerly in PyTorch; the Pallas kernels of the reference
become hand-written CUDA C++ kernels under `csrc/`, built at first use.
"""

__version__ = "0.1.0"
