"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors ``repro``'s module paths and public names.  Imports torch and numpy,
never JAX or ``repro``.  Entry points run on the card unless the caller
passes ``device="cpu"``; CUDA tensors go to the hand-written kernels in
``kernels/csrc``, CPU tensors to their plain PyTorch versions.
"""
