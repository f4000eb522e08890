"""Plain PyTorch version of the fused SIL-MSE loss (paper Eq. 1 target, MSE
loss), as ``repro/kernels/sil_mse/ref.py``.  Runs on any device.

loss = mean_t mean_i ( act[t, i] - SIL[i, y_t] )^2

It materializes the gathered (T, d) target, which the CUDA kernel never
does; the CPU path and the card's yardstick use it.  ``sil`` may have any
strides (the trainer passes a (d, M) view of a contiguous (M, d) table).
"""
from __future__ import annotations

import torch


def _target(sil, labels):
    return sil[:, labels.long()].t().float()          # (T, d)


def sil_mse(act, sil, labels):
    """act: (T, d) boundary activations; sil: (d, M); labels: (T,) int.
    Returns the fp32 scalar mean-squared error (the left-partition loss)."""
    diff = act.float() - _target(sil, labels)
    return torch.mean(diff * diff)


def sil_mse_grad_act(act, sil, labels):
    """d loss / d act -- (T, d) in fp32."""
    t, d = act.shape
    return (2.0 / (t * d)) * (act.float() - _target(sil, labels))
