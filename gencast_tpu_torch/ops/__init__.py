"""Device-side ops: plain PyTorch versions and their CUDA kernels."""
