"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the device dispatch between them."""
