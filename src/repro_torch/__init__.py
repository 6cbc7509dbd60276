"""PyTorch/CUDA port of the ``repro`` package (APEnet+ torus reproduction).

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch and runs the TPU kernels' counterparts as CUDA
kernels written for Hopper (``kernels/csrc``).  It imports no JAX and
nothing of ``repro``.
"""
