"""Fused SIL-MSE loss as a ``torch.autograd.Function`` (counterpart of
``repro/kernels/sil_mse/ops.py``).

Forward goes to the CUDA kernel for a CUDA tensor and to ``ref.py`` for a
CPU tensor (``dispatch.decide``); there is no fallback.  Both difference and
reduce in fp32 and return an fp32 scalar.  The forward pass already has
dL/dact, so it saves that grad for backward instead of recomputing it, as
the reference's VJP does (``ops.py:32-34``).

Backward returns ``g * grad`` in act's dtype, zero cotangent for the frozen
SIL table (``None``) and none for the integer labels, as the reference's
zero SIL cotangent and ``float0`` labels.  For a bf16 act the saved grad is
already rounded to bf16, so ``g * grad`` rounds twice where the reference
rounds once; the two agree for ``g == 1``, the only upstream gradient on the
training path (no loss scaling).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import KERNEL, decide

from . import ref


def sil_mse_with_grad(act, sil, labels):
    """(fp32 mean loss, dloss/dact in act's dtype) by the device's path."""
    if decide("sil_mse", act) == KERNEL:
        from .kernel import sil_mse_cuda
        return sil_mse_cuda(act, sil, labels)
    return (ref.sil_mse(act, sil, labels),
            ref.sil_mse_grad_act(act, sil, labels).to(act.dtype))


class _SilMse(torch.autograd.Function):

    @staticmethod
    def forward(ctx, act, sil, labels):
        loss, grad = sil_mse_with_grad(act.detach(), sil.detach(), labels)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return (grad * g).to(grad.dtype), None, None


def sil_mse(act, sil, labels):
    """act: (T, d); sil: (d, M) frozen table; labels: (T,) int -> fp32
    scalar mean of (act - SIL[:, labels].T)^2."""
    return _SilMse.apply(act, sil, labels)
