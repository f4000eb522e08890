"""Blocks for the ported slices, counterpart of ``repro/models/layers.py``
(dense, RMSNorm and LayerNorm, RoPE, GQA attention with KV-cache decode,
the SwiGLU and GELU MLPs, the token-choice mixture-of-experts FFN with
SwiGLU or GELU experts, the Mamba-1 block, the xLSTM blocks: chunkwise
mLSTM and recurrent sLSTM).  Params are nested dicts of tensors with the
reference's names and layouts; functions are plain PyTorch on tensors.

Attention decode updates the KV cache IN PLACE (where the reference returns
a new cache from a donated buffer) and returns the same tensors; Mamba and
xLSTM decode return their new state, which the caller writes into its
cache.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (decode_attention,
                                                 flash_attention,
                                                 paged_decode_attention)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_step)


def as_dtype(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, without a copy when it already is."""
    return t if t.dtype == dtype else t.to(dtype)


def dense(p, x):
    """Promote-at-boundary matmul: the weight is cast to the activation's
    (compute) dtype at the op.  Weights already stored in that dtype (the
    engine's compute copy) are used as they are, with the same values."""
    y = x @ as_dtype(p["w"], x.dtype)
    if "b" in p:
        y = y + as_dtype(p["b"], x.dtype)
    return y


def residual_add(x, out):
    """Residual adds accumulate in fp32 and round once to the compute dtype."""
    if x.dtype == torch.float32:
        return x + out
    return (x.float() + out.float()).to(x.dtype)


def norm_apply(p, x, eps=1e-5):
    """LayerNorm where the params hold a ``bias``, else RMSNorm: the mean,
    the variance (or mean square) over d and ``rsqrt`` in fp32, as the
    reference computes them; result in x's dtype."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rope_dim(head_dim: int, fraction: float) -> int:
    r = int(head_dim * fraction)
    return max(2, r - (r % 2))


def rope_tables(positions, head_dim, fraction, theta):
    """positions: (S,) int tensor -> cos/sin tables (S, rot/2) in fp32."""
    rot = rope_dim(head_dim, fraction)
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / torch.pow(torch.tensor(float(theta), dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x, cos, sin, *, per_batch=False):
    """x: (B, S, H, D); cos/sin: (S, rot/2), or (B, rot/2) with
    per_batch=True (one position per request, S == 1).  Rotates the
    interleaved pairs of the first `rot` dims."""
    rot2 = cos.shape[-1]
    xr, xp = x[..., : 2 * rot2], x[..., 2 * rot2:]
    if per_batch:
        c, s = cos[:, None, None, :].float(), sin[:, None, None, :].float()
    else:
        c, s = cos[None, :, None, :].float(), sin[None, :, None, :].float()
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def _split_heads(x, n):
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def attention_apply(p, x, cfg, *, rope_cs=None, causal=True, window=0,
                    kv_override=None):
    """Full-sequence attention (train / prefill / encoder / cross).

    kv_override: a source sequence (B, Sk, d) for cross-attention: K and V
    are projected from it, no rope is applied, and the attention is
    non-causal.  Returns (out, (k, v)) so callers can build caches."""
    src = x if kv_override is None else kv_override
    q = _split_heads(dense(p["wq"], x), cfg.n_heads)
    k = _split_heads(dense(p["wk"], src), cfg.n_kv_heads)
    v = _split_heads(dense(p["wv"], src), cfg.n_kv_heads)
    if rope_cs is not None and kv_override is None:
        cos, sin = rope_cs
        q = rope_apply(q, cos, sin)
        k = rope_apply(k, cos, sin)
    out = flash_attention(q, k, v, causal=causal and kv_override is None,
                          window=window)
    return dense(p["wo"], out.reshape(*x.shape[:2], -1)), (k, v)


def attention_decode(p, x, cfg, cache_kv, pos, *, rope_cs=None, window=0,
                     cross_kv=None, paged=None):
    """One-token decode. x: (B,1,d); cache_kv: (k, v) each (B,Lc,KV,hd), or
    with ``paged`` physical block pools (NB,BS,KV,hd).

    pos: int or (B,) int tensor.  paged: optional ``(block_tables,
    logical_len)``; free table entries point at the garbage block, which is
    written but never read (the ``slot < logical_len`` / ``slot <= pos``
    mask).  The new K/V row is written into the cache in place; returns
    (out, (k_cache, v_cache)).  For cross-attention pass ``cross_kv``, the
    encoder's (k, v) each (B, Lc, KV, hd), and ``cache_kv=None``: every slot
    is attended (pos Lc - 1), nothing is written, and the cache returned is
    None."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    b = x.shape[0]
    q = _split_heads(dense(p["wq"], x), h)
    if cross_kv is not None:
        ck, cv = cross_kv
        out = decode_attention(q, ck, cv, ck.shape[1] - 1)
        return dense(p["wo"], out.reshape(*x.shape[:2], -1)), None
    k = _split_heads(dense(p["wk"], x), kv)
    v = _split_heads(dense(p["wv"], x), kv)
    pos_t = torch.as_tensor(pos, device=x.device)
    if rope_cs is not None:
        cos, sin = rope_cs
        per_batch = cos.dim() == 2 and cos.shape[0] == b and pos_t.dim() == 1
        q = rope_apply(q, cos, sin, per_batch=per_batch)
        k = rope_apply(k, cos, sin, per_batch=per_batch)
    kc, vc = cache_kv
    pos_b = pos_t.reshape(-1).expand(b).long()
    rows = torch.arange(b, device=x.device)
    if paged is not None:
        bt, lc = paged
        bs = kc.shape[1]
        slot = (pos_b % lc) if window else torch.clamp(pos_b, max=lc - 1)
        phys = bt.long()[rows, slot // bs]
        off = slot % bs
        kc[phys, off] = k[:, 0].to(kc.dtype)
        vc[phys, off] = v[:, 0].to(vc.dtype)
        out = paged_decode_attention(q, kc, vc, bt, pos_t,
                                     logical_len=lc, window=window)
        return dense(p["wo"], out.reshape(*x.shape[:2], -1)), (kc, vc)
    lc = kc.shape[1]
    slot = (pos_b % lc) if window else torch.clamp(pos_b, max=lc - 1)
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    out = decode_attention(q, kc, vc, pos_t, window=window)
    return dense(p["wo"], out.reshape(*x.shape[:2], -1)), (kc, vc)


def gelu(x):
    """GELU in its tanh approximation, ``jax.nn.gelu``'s default (the exact
    erf form, ``F.gelu``'s default, differs by up to ~4e-4 in fp32)."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x):
    """SwiGLU MLP (``wg``/``wu``/``wd``), or the GELU MLP (``w1``/``w2``
    with biases)."""
    if "wg" in p:
        return dense(p["wd"], F.silu(dense(p["wg"], x)) * dense(p["wu"], x))
    return dense(p["w2"], gelu(dense(p["w1"], x)))


# --------------------------------------------------------------------------
# Mixture-of-experts FFN (token choice, per-expert capacity)
# --------------------------------------------------------------------------

def moe_capacity(tokens: int, moe_cfg) -> int:
    """Slots per expert: ceil(cf * T * k / E), at least 8, rounded up to a
    multiple of 8."""
    c = math.ceil(moe_cfg.capacity_factor * tokens * moe_cfg.top_k
                  / moe_cfg.num_experts)
    return max(8, c + (-c) % 8)


@contextlib.contextmanager
def _true_fp32(device):
    """CUDA fp32 matmuls without TF32 inside the block: TF32 keeps ~3
    digits and flips top-k choices near ties."""
    if device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


class _PairedGather(torch.autograd.Function):
    """``out[g, i] = src[g, fwd[g, i]]``, with row ``n`` (one past the end
    of ``src``) reading zeros.  The backward is the gather by the inverse
    map ``bwd`` (row ``m`` of the output's grad reading zeros), summed over
    ``k`` consecutive rows in fp32: every source row receives its grads in a
    fixed order, where autograd's index backward scatters with atomics."""

    @staticmethod
    def forward(ctx, src, fwd, bwd, k):
        ctx.save_for_backward(bwd)
        ctx.k = k
        return _gather_rows(src, fwd)

    @staticmethod
    def backward(ctx, grad):
        bwd, = ctx.saved_tensors
        g = _gather_rows(grad, bwd)
        if ctx.k > 1:
            gs, n, d = g.shape
            g = g.reshape(gs, n // ctx.k, ctx.k, d).sum(2, dtype=torch.float32
                                                         ).to(grad.dtype)
        return g, None, None, None


def _gather_rows(src, idx):
    """src (G, N, d), idx (G, M) in [0, N] -> (G, M, d); index N reads
    zeros."""
    gs, n, d = src.shape
    pad = torch.cat([src, src.new_zeros((gs, 1, d))], dim=1)
    off = torch.arange(gs, device=src.device)[:, None] * (n + 1)
    return pad.reshape(gs * (n + 1), d).index_select(
        0, (idx + off).reshape(-1)).reshape(gs, idx.shape[1], d)


def moe_route(router, xt, moe_cfg, c):
    """Routing of token groups xt (G, T, d) at capacity c, in fp32.
    Returns (logits (G, T, E), probs (G, T, E), gate (G, T, K) renormalized,
    eid (G, T, K), pos (G, T*K) the slot of each token-major (t, k) pick in
    its expert, keep (G, T*K) = pos < c, counts (G, E) picks per expert,
    dropped ones included)."""
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    with _true_fp32(xt.device):
        logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = eid.reshape(eid.shape[0], -1)
    # the one-hot laid out (G, E, T*K): the running count per expert is a
    # scan along the last dim, which CUDA runs in parallel (along a middle
    # dim it runs one thread per expert over the T*K picks)
    experts = torch.arange(e, device=xt.device)[None, :, None]
    onehot = (flat_e[:, None, :] == experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, flat_e[:, None, :])[:, 0]
    return logits, probs, gate, eid, pos, pos < c, onehot.sum(-1)


def _moe_dispatch(p, xt, moe_cfg, c):
    """Dispatch, experts and combine for token groups xt (G, T, d), the
    reference's ``_moe_dispatch_one`` on each group.  Returns (out (G, T, d)
    fp32, lb (G,), z (G,))."""
    gs, t, d = xt.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    logits, probs, gate, eid, pos, keep, counts = moe_route(
        p["router"], xt, moe_cfg, c)
    flat_e = eid.reshape(gs, t * k)
    tk = torch.arange(t * k, device=xt.device).expand(gs, -1)
    # (t, k) -> its slot e*C + pos, or E*C (a zero row) when dropped; and
    # the inverse, slot -> the (t, k) that fills it, or T*K when empty,
    # scattered with every dropped pick to a column of its own past E*C
    tk_slot = torch.where(keep, flat_e * c + pos,
                          torch.full_like(flat_e, e * c))
    slot_tk = torch.full((gs, e * c + t * k), t * k, dtype=torch.long,
                         device=xt.device)
    slot_tk.scatter_(1, torch.where(keep, tk_slot, e * c + tk),
                     tk.contiguous())
    slot_tk = slot_tk[:, :e * c]
    slot_tok = torch.where(slot_tk < t * k, slot_tk // k,
                           torch.full_like(slot_tk, t))
    # a token's k picks fill distinct slots: the backward gathers each
    # token's k slot grads and sums them by a reshape
    ein = _PairedGather.apply(xt, slot_tok, tk_slot, k)      # (G, E*C, d)
    ein = ein.reshape(gs, e, c, d).transpose(0, 1).reshape(e, gs * c, d)
    if "wg" in p:
        hg = torch.bmm(ein, as_dtype(p["wg"], ein.dtype))
        hu = torch.bmm(ein, as_dtype(p["wu"], ein.dtype))
        eout = torch.bmm(F.silu(hg) * hu, as_dtype(p["wd"], ein.dtype))
    else:
        eout = torch.bmm(gelu(torch.bmm(ein, as_dtype(p["w1"], ein.dtype))),
                         as_dtype(p["w2"], ein.dtype))
    eout = eout.reshape(e, gs, c, d).transpose(0, 1).reshape(gs, e * c, d)
    # combine: each (t, k) reads its slot (zeros when dropped) weighted by
    # its gate, summed over k in fp32
    out_flat = _PairedGather.apply(eout, tk_slot, slot_tk, 1)  # (G, T*K, d)
    w = (keep.float() * gate.reshape(gs, t * k))[..., None]
    out = (out_flat.float() * w).reshape(gs, t, k, d).sum(2)
    # switch load balance (dropped picks counted) and router z-loss
    lb = e * (probs.mean(1) * (counts.float() / t)).sum(-1) / k
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean(-1)
    return out, lb, z


def moe_apply(p, x, moe_cfg, *, capacity=None, groups: int = 1):
    """x: (B, S, d) -> (out in x's dtype, aux {"lb_loss", "z_loss"}).

    Token-choice dispatch: the router's top-k experts of each token, in
    fp32, each expert holding at most ``capacity`` (default
    ``moe_capacity``) token rows; a pick past it is dropped, in the
    token-major order of the (T*K) picks.  ``groups > 1`` (dividing B*S)
    splits the tokens into independent dispatch groups, each with its own
    capacity, and averages the aux losses over them.  The reference's
    ``gather_weights`` sharding constraint has no counterpart on one card
    (``models.model`` refuses it)."""
    b, s, d = x.shape
    t = b * s
    if groups > 1 and t % groups == 0:
        tg = t // groups
        c = capacity if capacity is not None else moe_capacity(tg, moe_cfg)
        xt = x.reshape(groups, tg, d)
    else:
        c = capacity if capacity is not None else moe_capacity(t, moe_cfg)
        xt = x.reshape(1, t, d)
    out, lb, z = _moe_dispatch(p, xt, moe_cfg, c)
    aux = {"lb_loss": lb.mean(), "z_loss": z.mean()}
    return out.reshape(b, s, d).to(x.dtype), aux


# --------------------------------------------------------------------------
# Mamba-1 block
# --------------------------------------------------------------------------

def mamba_dims(cfg):
    """(d_inner, dt_rank, d_state, d_conv) of the config's Mamba block."""
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    dt_rank = ssm.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, ssm.d_state, ssm.d_conv


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,Di), w: (K,Di).  The reference's K
    shifted multiply-adds in x's dtype (no cuDNN, so no TF32 under fp32)."""
    k, s = w.shape[0], x.shape[1]
    w = as_dtype(w, x.dtype)
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi * w[i][None, None]
    return out + as_dtype(b, x.dtype)[None, None]


def mamba_apply(p, x, cfg, *, state=None):
    """Full-sequence mamba. x: (B,S,d). Returns (out, final_state), with
    final_state = (conv_state (B, K-1, Di) in x's dtype, ssm_state
    (B, Di, N) fp32).  The scan runs through the selective-scan kernel for
    CUDA tensors; B and C reach it as column views of x_proj's output."""
    d_in, dt_rank, n, d_conv = mamba_dims(cfg)
    xz = dense(p["in_proj"], x)
    xi, z = torch.split(xz, d_in, dim=-1)
    h0 = None
    if state is not None:
        conv_st, h0 = state
        xi_ext = torch.cat([as_dtype(conv_st, xi.dtype), xi], dim=1)
    else:
        xi_ext = xi
    xc = _causal_conv(xi_ext, p["conv_w"], p["conv_b"])[:, -xi.shape[1]:]
    xc = F.silu(xc)
    xdb = dense(p["x_proj"], xc)
    dt_r, bmat, cmat = torch.split(xdb, [dt_rank, n, n], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt_r).float())
    a = -torch.exp(p["A_log"].float())
    y, h_last = selective_scan(xc, dt, a, bmat.float(), cmat.float(),
                               p["D"].float(), h0=h0)
    y = y * F.silu(z)
    out = dense(p["out_proj"], y)
    # next conv state = last (d_conv - 1) raw inputs (front-padded for
    # short S)
    padded = F.pad(xi_ext, (0, 0, d_conv - 1, 0))
    new_conv = padded[:, -(d_conv - 1):]
    return out, (new_conv, h_last)


def mamba_decode(p, x, cfg, state):
    """One-token decode. x: (B,1,d); state = (conv (B, K-1, Di), ssm
    (B, Di, N) fp32) from mamba_apply or the cache.  The step is the plain
    ``selective_scan_step`` on every device, as in the reference.  Returns
    (out, (new_conv, new_ssm)); the caller writes them into its cache."""
    d_in, dt_rank, n, d_conv = mamba_dims(cfg)
    conv_st, h = state
    xz = dense(p["in_proj"], x)
    xi, z = torch.split(xz, d_in, dim=-1)                  # (B,1,Di)
    window = torch.cat([as_dtype(conv_st, xi.dtype), xi], dim=1)  # (B,K,Di)
    # the reference's einsum "bkd,kd->bd": products summed in fp32, rounded
    # once to the compute dtype
    w = p["conv_w"]
    xc = (window.float() * w.float()[None]).sum(1).to(xi.dtype) \
        + as_dtype(p["conv_b"], xi.dtype)[None]
    xc = F.silu(xc)                                        # (B, Di)
    xdb = xc @ as_dtype(p["x_proj"]["w"], xc.dtype)
    dt_r, bvec, cvec = torch.split(xdb, [dt_rank, n, n], dim=-1)
    dt = F.softplus((dt_r @ as_dtype(p["dt_proj"]["w"], xc.dtype)
                     + as_dtype(p["dt_proj"]["b"], xc.dtype)).float())
    a = -torch.exp(p["A_log"].float())
    y, h_new = selective_scan_step(xc.float(), dt, a, bvec.float(),
                                   cvec.float(), p["D"].float(), h)
    y = (y[:, None] * F.silu(z)).to(x.dtype)
    out = dense(p["out_proj"], y)
    return out, (window[:, 1:], h_new)


# --------------------------------------------------------------------------
# xLSTM blocks (the reference computes them in jnp, without a Pallas kernel)
# --------------------------------------------------------------------------

def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """The Python scalar ``v`` rounded to ``dtype``, as JAX rounds a scalar
    that multiplies an array of that type."""
    return torch.tensor(v, dtype=dtype).item()


def _mlstm_chunk(q, k, v, i_g, f_g, state, nstate):
    """One chunk of the gated-linear-attention recurrence, the reference's
    ``_mlstm_chunk`` with the heads before time.  q, k, v: (B, H, c, dh)
    fp32; i_g, f_g: (B, H, c) in (0, 1); state (B, H, dh, dh), nstate
    (B, H, dh).  Returns (h (B, H, c, dh), state', nstate')."""
    c = q.shape[2]
    cf = torch.cumsum(torch.log(f_g + 1e-9), dim=-1)           # (B,H,c)
    # inter-chunk: decay from the chunk's start
    qd = q * torch.exp(cf)[..., None]
    h_inter = qd @ state
    n_inter = (qd @ nstate[..., None])[..., 0]
    # intra-chunk, (B, H, t, j); mask BEFORE exp: exp of the masked
    # (positive) entries would overflow and poison the backward with
    # 0 * inf = NaN
    rel = cf[..., :, None] - cf[..., None, :]
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    w = torch.exp(torch.where(mask, rel, float("-inf")))
    w = w * i_g[..., None, :]                                   # gate at j
    sw = (q @ k.transpose(-1, -2)) * w
    h = h_inter + sw @ v
    n = n_inter + sw.sum(-1)
    h = h / torch.clamp(n.abs(), min=1.0)[..., None]
    # the state carried to the chunk's end
    last = cf[..., -1:]                                         # (B,H,1)
    kd = k * (i_g * torch.exp(last - cf))[..., None]
    state = state * torch.exp(last)[..., None] + kd.transpose(-1, -2) @ v
    nstate = nstate * torch.exp(last) + kd.sum(-2)
    return h, state, nstate


def mlstm_apply(p, x, cfg, *, state=None):
    """Chunkwise mLSTM over x (B, S, d): returns (out, (C (B, H, dh, dh),
    n (B, H, dh)), both fp32).  The gates read x in fp32 (``w_i``/``w_f``
    are fp32 weights); q and k are scaled in the compute dtype, then the
    recurrence runs in fp32 over chunks of ``cfg.xlstm.chunk_size`` (or S
    when shorter), the last padded to a whole chunk with f = 1 and i = 0,
    which leaves the state as it was; h returns to x's dtype before the
    ``sigmoid(z)`` gate and ``down``."""
    b, s, _ = x.shape
    hn = cfg.n_heads
    xin, z = torch.chunk(dense(p["up"], x), 2, dim=-1)         # (B,S,d_up)
    d_up = xin.shape[-1]
    dh = d_up // hn
    scale = _in_dtype(dh ** -0.5, x.dtype)
    chunk = min(cfg.xlstm.chunk_size, s)
    pad = (-s) % chunk

    def heads(t):          # (B, S, d_up) -> (B, H, S + pad, dh) fp32
        t = t.reshape(b, s, hn, dh).transpose(1, 2).float()
        return F.pad(t, (0, 0, 0, pad)).contiguous()

    q = heads(dense(p["wq"], xin) * scale)
    k = heads(dense(p["wk"], xin) * scale)
    v = heads(dense(p["wv"], xin))
    xf = x.float()
    i_g = F.pad(torch.sigmoid(dense(p["w_i"], xf)).transpose(1, 2), (0, pad))
    f_g = F.pad(torch.sigmoid(dense(p["w_f"], xf)).transpose(1, 2), (0, pad),
                value=1.0)
    if state is None:
        st = x.new_zeros((b, hn, dh, dh), dtype=torch.float32)
        nst = x.new_zeros((b, hn, dh), dtype=torch.float32)
    else:
        st, nst = state
    hs = []
    for c0 in range(0, s + pad, chunk):
        cs = slice(c0, c0 + chunk)
        h, st, nst = _mlstm_chunk(q[:, :, cs], k[:, :, cs], v[:, :, cs],
                                  i_g[..., cs], f_g[..., cs], st, nst)
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :s].transpose(1, 2).reshape(b, s, d_up)
    out = dense(p["down"], h.to(x.dtype) * torch.sigmoid(z))
    return out, (st, nst)


def mlstm_decode(p, x, cfg, state):
    """One-token mLSTM decode: the same chunk math at c = 1."""
    return mlstm_apply(p, x, cfg, state=state)


def _slstm_step(r, xt, state):
    """One sLSTM step.  r: (H, dh, 4dh) fp32 block-diagonal recurrent
    weights; xt: (B, H, 4dh) fp32, the step's pre-projected input [z | i |
    f | o] (each d wide) viewed by head; state (h, c, n, m), each (B, d)
    fp32.  The recurrent term (B, H, 4dh) is added head-major, as the
    reference's reshape to (B, 4d) lays it: with 4 heads, the z gate's
    recurrent input is head 0's product.  Exponential gating on the raw
    pre-activations with the stabiliser ``m_new = max(f + m, i)``.
    Returns the new state and the intermediates the backward reads:
    (z, o, f + m, i, exp(i - m_new), exp(f + m - m_new), max(n_new, 1e-6))."""
    h, c, n, m = state
    hn, dh, _ = r.shape
    b, d = h.shape
    rec = torch.bmm(h.reshape(b, hn, dh).transpose(0, 1), r)    # (H,B,4dh)
    z_t, i_t, f_t, o_t = (xt + rec.transpose(0, 1)).reshape(b, 4, d).unbind(1)
    z_t = torch.tanh(z_t)
    o_t = torch.sigmoid(o_t)
    fm = f_t + m
    m_new = torch.maximum(fm, i_t)                 # log-space stabiliser
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(fm - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    q = torch.clamp(n_new, min=1e-6)
    h_new = o_t * c_new / q
    return (h_new, c_new, n_new, m_new), (z_t, o_t, fm, i_t, i_p, f_p, q)


class _SLSTMSequence(torch.autograd.Function):
    """The sLSTM recurrence over a sequence: ``_slstm_step`` once a token,
    with a backward through time written out by hand.  Autograd of the
    step loop records ~20 nodes a token and keeps ~15 saved tensors a
    token, each through the saved-tensor hooks of ``remat``'s checkpoint;
    this forward stacks each intermediate once and the backward makes ~30
    launches a token, the recurrent weights' gradient one product over
    every step at the end.  The chain rule is autograd's
    of the same ops: ``maximum`` gives half the gradient to each side of a
    tie, ``clamp`` passes it where n >= 1e-6.

    forward(xs (B, S, H, 4dh), r (H, dh, 4dh), h0, c0, n0, m0 (B, d)), all
    fp32 -> (hs (B, S, d), c_S, n_S, m_S); h_S is hs[:, -1]."""

    @staticmethod
    def forward(ctx, xs, r, h0, c0, n0, m0):
        state, hs, cs, ns, keep = (h0, c0, n0, m0), [h0], [c0], [n0], []
        for xt in xs.unbind(1):
            state, inter = _slstm_step(r, xt, state)
            hs.append(state[0])
            cs.append(state[1])
            ns.append(state[2])
            keep.append(inter)
        stacked = [torch.stack(t) for t in (hs, cs, ns)] + [
            torch.stack(t) for t in zip(*keep)]
        ctx.save_for_backward(r, *stacked)
        return torch.stack(hs[1:], dim=1), state[1], state[2], state[3]

    @staticmethod
    def backward(ctx, g_hs, g_c, g_n, g_m):
        r, *saved = ctx.saved_tensors
        H, C, N, Z, O, FM, I, IP, FP, Q = saved
        s, b, d = Z.shape
        hn, dh, _ = r.shape
        h_in = H[:-1].view(s, b, hn, dh)       # each step's recurrent input
        # routing of the gradient through clamp and maximum, every step
        n_pass = (N[1:] >= 1e-6).float().unbind(0)
        to_fm = torch.where(FM > I, 1.0, torch.where(FM == I, 0.5, 0.0)
                            ).unbind(0)
        # one view a step of each stack (indexing one would be an op a step)
        H, C, N, Z, O, FM, I, IP, FP, Q = (t.unbind(0) for t in saved)
        g_out = g_hs.unbind(1)
        r_t = r.transpose(1, 2)
        g_h, gzifo = None, []
        for t in range(s - 1, -1, -1):
            gh = g_out[t] if g_h is None else g_out[t] + g_h
            a = gh / Q[t]
            g_o = a * C[t + 1]
            g_ct = g_c + a * O[t]
            g_nt = g_n - (a * H[t + 1]) * n_pass[t]
            g_fp = g_ct * C[t] + g_nt * N[t]
            g_ip = g_ct * Z[t] + g_nt
            e_i = g_ip * IP[t]
            e_f = g_fp * FP[t]
            g_mt = g_m - e_i - e_f
            fm_part = g_mt * to_fm[t]
            g_fm = e_f + fm_part
            g_i = e_i + (g_mt - fm_part)
            gz = torch.ops.aten.tanh_backward(g_ct * IP[t], Z[t])
            go = torch.ops.aten.sigmoid_backward(g_o, O[t])
            gt = torch.cat([gz, g_i, g_fm, go], dim=-1)          # (B, 4d)
            gzifo.append(gt)
            g_h = torch.bmm(gt.view(b, hn, 4 * dh).transpose(0, 1), r_t
                            ).transpose(0, 1).reshape(b, d)
            g_c, g_n, g_m = g_ct * FP[t], g_nt * FP[t], g_fm
        g_xs = torch.stack(gzifo[::-1], dim=1).view(b, s, hn, 4 * dh)
        g_r = torch.einsum("sbhd,bshe->hde", h_in, g_xs)
        return g_xs, g_r, g_h, g_c, g_n, g_m


def slstm_apply(p, x, cfg, *, state=None):
    """Recurrent sLSTM over x (B, S, d): returns (out, (h, c, n, m)), the
    state fp32 (B, d) each.  ``w_in`` projects every step's input at once
    (in the compute dtype), which is cast to fp32 once before the steps
    (``_SLSTMSequence``); the outputs h return to x's dtype for ``out``.
    The state before the first token: h, c, n zeros and the stabiliser m
    at -1e9."""
    b, s, d = x.shape
    hn = cfg.n_heads
    xs = dense(p["w_in"], x).float().reshape(b, s, hn, 4 * (d // hn))
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full((b, d), -1e9, dtype=torch.float32,
                                     device=x.device))
    hs, c, n, m = _SLSTMSequence.apply(xs, p["r"].float(), *state)
    out = dense(p["out"], hs.to(x.dtype))
    return out, (hs[:, -1], c, n, m)


def slstm_decode(p, x, cfg, state):
    """One-token sLSTM decode. x: (B, 1, d); state (h, c, n, m)."""
    xt = dense(p["w_in"], x)[:, 0].float().reshape(x.shape[0], cfg.n_heads,
                                                    -1)
    st, _ = _slstm_step(p["r"].float(), xt, state)
    out = dense(p["out"], st[0][:, None].to(x.dtype))
    return out, st
