"""Kernel dispatch by tensor device (counterpart of ``repro/kernels/dispatch.py``).

``decide(family, tensor)`` picks the path of one call: a CUDA tensor goes
to the hand-written kernel, a CPU tensor to the plain PyTorch version.
There is no environment override and no fallback: a kernel that fails to
build or launch raises.

Every kernel that a training path differentiates has its backward kernel
behind a ``torch.autograd.Function`` (``kernels/flash_attention/ops.py``,
``kernels/selective_scan/ops.py``, ``kernels/sil_mse/ops.py``); the decode
kernels serve only.

``LAUNCHES`` counts kernel launches per family.  Each wrapper in
``kernels/*/kernel.py`` adds one where it launches its kernel and nowhere
else, so a run can show which kernels its main path went through.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

KERNEL = "kernel"
PLAIN = "plain"


class LaunchCounter:
    """Kernel launches per family (a plain integer each)."""

    def __init__(self):
        self._counts: Counter = Counter()

    def add(self, family: str) -> None:
        self._counts[family] += 1

    def get(self, family: str) -> int:
        return self._counts[family]

    def snapshot(self) -> Dict[str, int]:
        return dict(self._counts)

    def reset(self) -> None:
        self._counts.clear()


LAUNCHES = LaunchCounter()


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; CUDA without a card raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run the plain "
                           "PyTorch path")
    return dev


def decide(family: str, tensor: torch.Tensor) -> str:
    """KERNEL for a CUDA tensor, PLAIN for a CPU tensor; raises otherwise."""
    if tensor.device.type == "cuda":
        return KERNEL
    if tensor.device.type == "cpu":
        return PLAIN
    raise ValueError(f"{family}: no kernel or plain path for device "
                     f"{tensor.device}")

