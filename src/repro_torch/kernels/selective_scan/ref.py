"""Plain PyTorch version of the Mamba selective scan, with the contract of
``repro/kernels/selective_scan/ref.py``.  Runs on any device.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t ;  y_t = C_t . h_t + D * u_t

``selective_scan`` is a loop of ``selective_scan_step`` over time, from
``h0`` or zeros, in fp32 throughout.  The reference's chunked associative
scan computes the same sums in another order; a step loop is the simplest
honest oracle for the CUDA kernel, which walks time the same way.  ``chunk``
is accepted for the reference's signature and changes nothing here.
"""
from __future__ import annotations

import torch


def selective_scan_step(u, dt, A, B, C, D, h):
    """One step. u, dt: (Ba, Di); A: (Di, N); B, C: (Ba, N); D: (Di,);
    h: (Ba, Di, N) fp32.  Returns (y (Ba, Di) in u's dtype, h_new fp32).
    The products are elementwise in fp32 (no matmul, so no TF32 on the
    card)."""
    uf, dtf = u.float(), dt.float()
    abar = torch.exp(dtf[..., None] * A.float()[None])
    bu = (dtf * uf)[..., None] * B.float()[:, None, :]
    h_new = abar * h.float() + bu
    y = (h_new * C.float()[:, None, :]).sum(-1) + uf * D.float()[None]
    return y.to(u.dtype), h_new


def selective_scan(u, dt, A, B, C, D, *, chunk=128, h0=None):
    """u, dt: (Ba, S, Di); A: (Di, N); B, C: (Ba, S, N); D: (Di,);
    h0: optional (Ba, Di, N).  Returns (y (Ba, S, Di) in u's dtype,
    h_last (Ba, Di, N) fp32)."""
    ba, s, di = u.shape
    n = A.shape[1]
    h = torch.zeros((ba, di, n), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    uf = u.float()
    ys = []
    for t in range(s):
        y, h = selective_scan_step(uf[:, t], dt[:, t], A, B[:, t], C[:, t],
                                   D, h)
        ys.append(y)
    y = torch.stack(ys, 1) if ys else uf.new_zeros((ba, 0, di))
    return y.to(u.dtype), h
