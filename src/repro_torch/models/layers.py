"""Transformer blocks for the ported slice, counterpart of
``repro/models/layers.py`` (dense, RMSNorm, RoPE, GQA attention with KV-cache
decode, SwiGLU MLP).  Params are nested dicts of tensors with the
reference's names and layouts; functions are plain PyTorch on tensors.

Decode updates the KV cache IN PLACE (where the reference returns a new
cache from a donated buffer) and returns the same tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (decode_attention,
                                                 flash_attention,
                                                 paged_decode_attention)


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
