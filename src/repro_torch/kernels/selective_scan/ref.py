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
in groups of four, then over the groups pairwise), and
``selective_scan_bwd_lanes`` the backward in its backward kernel's order;
the tests hold them against the reference package, and nothing else calls
them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.selective_scan.kernel import (BWD_CHANNELS,
                                                      BWD_PAIR, BWD_TILE,
                                                      STATES_PER_LANE)

LOG2E = 1.0 / math.log(2.0)
LN2 = math.log(2.0)


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


def _pairwise(parts):
    """Sum a list pairwise, as the kernels add their lanes: ((p0 + p1) +
    (p2 + p3)) for four."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def selective_scan_bwd_lanes(u, dt, A, B, C, D, dy, *, h0=None,
                             dh_last=None):
    """``selective_scan_bwd`` in the backward kernel's order.  A channel's
    states lie in N / 4 lanes of 4; a lane sums g B and g A2 exp(dt A)
    h_{t-1} (A2 = A log2 e, ddt takes the latter times ln 2) over its states
    left to right, with exp(dt A) h_{t-1} taken as h_t - dt u B, and the
    lanes' sums are added pairwise.  dB and dC: a thread's two channels,
    then per block of ``BWD_CHANNELS`` the 32 pairs in four groups of every
    fourth pair (each summed in order), the groups as ((G0 + G2) + (G1 +
    G3)), then the blocks in order.  dA: each (row, channel, state) over time
    from the last step, then the rows in order.  dD: lane q of a channel
    takes steps q * OWN .. q * OWN + OWN - 1 of every tile (OWN =
    ``BWD_TILE`` / lanes), the tiles from the last, and the lanes and then
    the rows are added in order.  fp32 throughout; du in u's dtype."""
    ba, s, di = u.shape
    n = A.shape[1]
    quad, lanes = STATES_PER_LANE, n // STATES_PER_LANE
    f = torch.float32
    uf, dtf, dyf = u.float(), dt.float(), dy.float()
    bf, cf = B.float(), C.float()
    a2 = A.float() * LOG2E
    h = torch.zeros((ba, di, n), dtype=f, device=u.device) \
        if h0 is None else h0.float()
    hs, facs = [], []
    for t in range(s):
        fac = torch.exp2(dtf[:, t, :, None] * a2)
        h = fac * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
        facs.append(fac)
    g = torch.zeros((ba, di, n), dtype=f, device=u.device) \
        if dh_last is None else dh_last.float().clone()
    du, ddt = torch.empty_like(uf), torch.empty_like(uf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros((ba, di, n), dtype=f, device=u.device)
    # channels padded to whole blocks: a dead channel adds exact zeros
    pad = -(-di // BWD_CHANNELS) * BWD_CHANNELS - di
    for t in reversed(range(s)):
        dtu = (dtf[:, t] * uf[:, t])[..., None]
        g = g + cf[:, t, None, :] * dyf[:, t, :, None]
        ah = hs[t] - dtu * bf[:, t, None, :]
        w = g * ah
        gl = (g * bf[:, t, None, :]).reshape(ba, di, lanes, quad)
        wl = (w * a2).reshape(ba, di, lanes, quad)
        gb = _pairwise([_left(gl[:, :, l]) for l in range(lanes)])
        gah = _pairwise([_left(wl[:, :, l]) for l in range(lanes)])
        du[:, t] = D.float() * dyf[:, t] + dtf[:, t] * gb
        ddt[:, t] = uf[:, t] * gb + gah * LN2
        da = da + w * dtf[:, t, :, None]
        for out, x in ((db, g * dtu), (dc, dyf[:, t, :, None] * hs[t])):
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            # (Ba, blocks, 32 pairs, BWD_PAIR, N) -> the pair's sum
            x = x.reshape(ba, -1, 32, BWD_PAIR, n)
            pair = x[:, :, :, 0]
            for k in range(1, BWD_PAIR):
                pair = pair + x[:, :, :, k]
            grp = [_left(list(pair[:, :, m::4].unbind(2))) for m in range(4)]
            blk = (grp[0] + grp[2]) + (grp[1] + grp[3])
            out[:, t] = _left(list(blk.unbind(1)))
        g = facs[t] * g
    # dD: each lane's steps in the kernel's order, then the lanes, the rows
    own = BWD_TILE // lanes
    ddl = torch.zeros((lanes, ba, di), dtype=f, device=u.device)
    for tile in reversed(range(-(-s // BWD_TILE))):
        for q in range(lanes):
            for r in range(own):
                t = tile * BWD_TILE + q * own + r
                if t < s:
                    ddl[q] = dyf[:, t] * uf[:, t] + ddl[q]
    dd = _left(list(_left(list(ddl.unbind(0))).unbind(0)))
    return (du.to(u.dtype), ddt, _left(list(da.unbind(0))), db, dc, dd,
            None if h0 is None else g)


def _left(parts):
    """Sum a list (or the last axis of a tensor) left to right, from the
    first term: the kernels' running sums."""
    if isinstance(parts, torch.Tensor):
        parts = list(parts.unbind(-1))
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc
