"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the device dispatch between them.

``FAMILIES`` is the declarative kernel inventory, the reference's: every
family listed here must keep a registered kernel-vs-plain oracle in
``repro_torch.verify`` (asserted by ``tests/test_torch_oracles.py``).
"""

# family name -> the entry points whose kernel and plain paths the
# repro_torch.verify oracle registry must cover
FAMILIES = {
    "flash_attention": ("flash_attention", "decode_attention"),
    "selective_scan": ("selective_scan",),
    "sil_mse": ("sil_mse",),
}
