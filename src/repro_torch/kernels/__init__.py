"""Kernels of the port: CUDA sources in ``csrc/`` (attention K1, K2; the
recurrent scans K3, K4; the training step's AdamW update), their wrappers,
their plain PyTorch versions (``ref``; the update's in ``optim/adamw.py``)
and the device dispatch (``ops``)."""
