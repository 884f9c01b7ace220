"""Tensor ops of the port: plain PyTorch functions and the wrappers of the
hand-written CUDA kernels (built on first use by :mod:`.build`)."""
