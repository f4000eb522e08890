"""Blocks for the ported slices, counterpart of ``repro/models/layers.py``
(dense, RMSNorm, RoPE, GQA attention with KV-cache decode, SwiGLU MLP, the
Mamba-1 block).  Params are nested dicts of tensors with the reference's
names and layouts; functions are plain PyTorch on tensors.

Attention decode updates the KV cache IN PLACE (where the reference returns
a new cache from a donated buffer) and returns the same tensors; Mamba
decode returns its new state, which the caller writes into its cache.
"""
from __future__ import annotations

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
    """RMSNorm in fp32, result in x's dtype."""
    xf = x.float()
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


def attention_apply(p, x, cfg, *, rope_cs=None, causal=True, window=0):
    """Full-sequence self-attention (prefill).  Returns (out, (k, v))."""
    q = _split_heads(dense(p["wq"], x), cfg.n_heads)
    k = _split_heads(dense(p["wk"], x), cfg.n_kv_heads)
    v = _split_heads(dense(p["wv"], x), cfg.n_kv_heads)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = rope_apply(q, cos, sin)
        k = rope_apply(k, cos, sin)
    out = flash_attention(q, k, v, causal=causal, window=window)
    return dense(p["wo"], out.reshape(*x.shape[:2], -1)), (k, v)


def attention_decode(p, x, cfg, cache_kv, pos, *, rope_cs=None, window=0,
                     paged=None):
    """One-token decode. x: (B,1,d); cache_kv: (k, v) each (B,Lc,KV,hd), or
    with ``paged`` physical block pools (NB,BS,KV,hd).

    pos: int or (B,) int tensor.  paged: optional ``(block_tables,
    logical_len)``; free table entries point at the garbage block, which is
    written but never read (the ``slot < logical_len`` / ``slot <= pos``
    mask).  The new K/V row is written into the cache in place; returns
    (out, (k_cache, v_cache))."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    b = x.shape[0]
    q = _split_heads(dense(p["wq"], x), h)
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


def mlp_apply(p, x):
    """SwiGLU MLP."""
    return dense(p["wd"], F.silu(dense(p["wg"], x)) * dense(p["wu"], x))


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
