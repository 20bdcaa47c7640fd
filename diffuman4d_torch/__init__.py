"""Diffuman4D on PyTorch and CUDA: the port of the JAX package
``diffuman4d_tpu`` for NVIDIA Hopper GPUs.

It mirrors the JAX package's layout (``ops``, ``models``, ``schedulers``,
``data``, ``sampling``, ``parallel``, ``training``, ``io``), keeps its NHWC / (B, S, H, D) layouts at
public functions, and keeps its own copies of the numpy-only host modules
(data loading, windows, outputs) and a ``training`` sub-package. It never
imports the JAX package, jax or flax. The hand-written CUDA kernels live in ``csrc`` and are
built at first use (``ops/cuda_build.py``).
"""

__version__ = "0.1.0"
