"""PyTorch/CUDA port of stabstitch2_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout module for module
(``config``, ``ops``, ``models``, ``pipeline``, ``data``, ``utils``,
``cli``) and imports nothing of it. Public functions keep the NHWC layout
of their JAX counterparts; the two hand-written CUDA kernels of the main
path live under ``csrc/`` and are built with ``nvcc`` on first use.
"""
