"""rtdsd-tpu on PyTorch and CUDA: the batch-scoring path of ``rtdsd_tpu``
ported to an NVIDIA Hopper GPU, with hand-written CUDA kernels in place of
the JAX package's Pallas kernels.

The package imports ``torch`` and never JAX or anything of ``rtdsd_tpu``;
every module it needs from there has its own copy here.
"""

__version__ = "0.1.0"
