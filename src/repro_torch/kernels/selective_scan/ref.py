"""Plain PyTorch version of the Mamba selective scan, with the contract of
``repro/kernels/selective_scan/ref.py``.  Runs on any device.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t ;  y_t = C_t . h_t + D * u_t

``selective_scan`` is a loop of ``selective_scan_step`` over time, from
``h0`` or zeros, in fp32 throughout.  The reference's chunked associative
scan computes the same sums in another order; a step loop is the simplest
honest oracle for the CUDA kernel, which walks time the same way.  ``chunk``
is accepted for the reference's signature and changes nothing here.

``selective_scan_lanes`` computes the same scan in the CUDA kernel's order
(each exponential as exp2 of dt times A * log2(e), a channel's states summed
in groups of four, then over the groups pairwise); the tests hold it against
the reference package, and nothing else calls it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.selective_scan.kernel import STATES_PER_LANE

LOG2E = 1.0 / math.log(2.0)


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


def selective_scan_bwd(u, dt, A, B, C, D, dy, *, h0=None, dh_last=None):
    """The gradient of ``selective_scan``'s (y, h_last) against dy (Ba, S,
    Di) and an optional dh_last (Ba, Di, N).  The states are recomputed
    forward and kept, then time is walked back with the state's gradient
    g_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1}.  fp32 throughout.  Returns
    (du in u's dtype, ddt, dA, dB, dC, dD, dh0): dh0 is None without h0."""
    ba, s, di = u.shape
    n = A.shape[1]
    uf, dtf, af = u.float(), dt.float(), A.float()
    bf, cf, dyf = B.float(), C.float(), dy.float()
    h = torch.zeros((ba, di, n), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    hs = [h]
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * af) * h \
            + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_last is None else dh_last.float().clone()
    du, ddt = torch.empty_like(uf), torch.empty_like(uf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    for t in reversed(range(s)):
        g = g + cf[:, t, None, :] * dyf[:, t, :, None]
        a = torch.exp(dtf[:, t, :, None] * af)
        ah = a * hs[t]
        dc[:, t] = (dyf[:, t, :, None] * hs[t + 1]).sum(1)
        db[:, t] = (g * (dtf[:, t] * uf[:, t])[..., None]).sum(1)
        gb = (g * bf[:, t, None, :]).sum(-1)
        du[:, t] = D.float() * dyf[:, t] + dtf[:, t] * gb
        ddt[:, t] = (g * af * ah).sum(-1) + uf[:, t] * gb
        da = da + (g * dtf[:, t, :, None] * ah).sum(0)
        g = a * g
    dd = (dyf * uf).sum((0, 1))
    return (du.to(u.dtype), ddt, da, db, dc, dd,
            None if h0 is None else g)


def selective_scan_lanes(u, dt, A, B, C, D, *, h0=None):
    """``selective_scan`` in the kernel's order.  The N states of a channel
    lie in N / 4 lanes of 4 states (``kernel.STATES_PER_LANE``); a lane sums
    C * h of its states left to right, the lanes' sums are added pairwise
    ((p0 + p1) + (p2 + p3) for four lanes), then D * u.  Every exp(dt * A)
    is computed once, as 2^(dt * (A * log2 e)).  fp32 throughout; y in u's
    dtype."""
    ba, s, di = u.shape
    n = A.shape[1]
    quad = STATES_PER_LANE
    lanes = n // quad
    a2 = A.float() * LOG2E
    h = torch.zeros((ba, di, n), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    uf, dtf = u.float(), dt.float()
    ys = []
    for t in range(s):
        dtv = dtf[:, t][..., None]
        du = (dtf[:, t] * uf[:, t])[..., None]
        h = torch.exp2(dtv * a2[None]) * h + du * B[:, t].float()[:, None]
        ch = (h * C[:, t].float()[:, None]).reshape(ba, di, lanes, quad)
        part = ch[..., 0]
        for i in range(1, quad):
            part = part + ch[..., i]
        while part.shape[-1] > 1:           # pairwise over the lanes
            part = part[..., 0::2] + part[..., 1::2]
        ys.append(part[..., 0] + D.float()[None] * uf[:, t])
    y = torch.stack(ys, 1) if ys else uf.new_zeros((ba, 0, di))
    return y.to(u.dtype), h
