"""Dispatching selective scan: the CUDA kernel for a CUDA tensor, the plain
PyTorch version in ``ref.py`` for a CPU tensor (``dispatch.decide``); there
is no fallback.  Same arguments as ``repro/kernels/selective_scan/ops.py``.
Both keep the recurrent state in fp32 and return y in u's dtype.

On its kernel branch ``selective_scan`` is differentiable: where grad mode
is on and an input requires grad, it runs ``_SelectiveScan``, a
``torch.autograd.Function`` whose forward is the kernel saving the state
entering every ``kernel.BWD_TILE`` steps and whose backward is the backward
kernel (``kernel.selective_scan_bwd_cuda``), the gradient JAX takes of
``ref.selective_scan``.  Otherwise (serving, ``torch.no_grad()``) it calls
the kernel alone.  The CPU path keeps the plain version's own autograd.

``selective_scan_step`` (one decode step) is the plain version on every
device, as in the reference, which computes it outside Pallas too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import KERNEL, decide

from . import kernel, ref


class _SelectiveScan(torch.autograd.Function):
    """The kernel forward with its states saved every ``kernel.BWD_TILE``
    steps, the backward kernel.  B and C may arrive as column views: their
    gradients come back contiguous and autograd copies them into the view's
    base."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, h0):
        y, h_last, states = kernel.selective_scan_fwd_saving_cuda(
            u, dt, A, B, C, D, h0=h0)
        ctx.save_for_backward(u, dt, A, B, C, D, states)
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, dt, A, B, C, D, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        du, ddt, dA, dB, dC, dD, dh0 = kernel.selective_scan_bwd_cuda(
            u, dt, A, B, C, D, states, dy, dh_last=dh_last,
            want_dh0=ctx.has_h0 and ctx.needs_input_grad[6])
        return du, ddt, dA, dB, dC, dD, dh0


def selective_scan(u, dt, A, B, C, D, *, chunk=128, h0=None):
    """u, dt: (Ba, S, Di); A: (Di, N); B, C: (Ba, S, N); D: (Di,); h0:
    optional (Ba, Di, N).  Returns (y (Ba, S, Di), h_last (Ba, Di, N) fp32).
    ``chunk`` is the reference's time tile, kept for its signature; neither
    path reads it.  The kernel stages time in its own tiles of
    ``kernel.TILE`` steps (``kernel.scan_plan``), and the plain path walks
    one step at a time."""
    if decide("selective_scan", u) == KERNEL:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (u, dt, A, B, C, D, h0)):
            return _SelectiveScan.apply(u, dt, A, B, C, D, h0)
        return kernel.selective_scan_cuda(u, dt, A, B, C, D, h0=h0)
    return ref.selective_scan(u, dt, A, B, C, D, chunk=chunk, h0=h0)


selective_scan_step = ref.selective_scan_step
