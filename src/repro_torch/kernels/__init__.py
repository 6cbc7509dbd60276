"""Attention kernels of the serving path: CUDA sources in ``csrc/``, their
wrappers, their plain PyTorch versions (``ref``) and the device dispatch
(``ops``)."""
