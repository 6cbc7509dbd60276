"""Kernels of the port: CUDA sources in ``csrc/`` (attention K1, K2; the
recurrent scans K3, K4), their wrappers, their plain PyTorch versions
(``ref``) and the device dispatch (``ops``)."""
