"""Dispatching selective scan: the CUDA kernel for a CUDA tensor, the plain
PyTorch version in ``ref.py`` for a CPU tensor (``dispatch.decide``); there
is no fallback.  Same arguments as ``repro/kernels/selective_scan/ops.py``.
Both keep the recurrent state in fp32 and return y in u's dtype.

``selective_scan_step`` (one decode step) is the plain version on every
device, as in the reference, which computes it outside Pallas too.

The kernel has no backward yet, so ``selective_scan`` refuses a CUDA input
that requires grad under grad mode (``dispatch.refuse_grad``) instead of
returning outputs without a ``grad_fn``; the CPU path keeps its autograd.
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import KERNEL, decide, refuse_grad

from . import ref


def selective_scan(u, dt, A, B, C, D, *, chunk=128, h0=None):
    """u, dt: (Ba, S, Di); A: (Di, N); B, C: (Ba, S, N); D: (Di,); h0:
    optional (Ba, Di, N).  Returns (y (Ba, S, Di), h_last (Ba, Di, N) fp32).
    ``chunk`` is the reference's time tile, kept for its signature; neither
    path reads it.  The kernel stages time in its own tiles of
    ``kernel.TILE`` steps (``kernel.scan_plan``), and the plain path walks
    one step at a time."""
    if decide("selective_scan", u) == KERNEL:
        refuse_grad("selective_scan", (u, dt, A, B, C, D, h0),
                    "ROADMAP queue B row 5")
        from .kernel import selective_scan_cuda
        return selective_scan_cuda(u, dt, A, B, C, D, h0=h0)
    return ref.selective_scan(u, dt, A, B, C, D, chunk=chunk, h0=h0)


selective_scan_step = ref.selective_scan_step
