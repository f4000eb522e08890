"""Plain PyTorch attention, ported from ``repro/kernels/flash_attention/ref.py``.

The masking contracts are the reference's, exactly:

* prefill: queries are aligned to the end of the keys (qpos = i + Sk - Sq);
  causal keeps kpos <= qpos, a window keeps kpos > qpos - window;
* a row whose every key is masked returns 0 (chunked: the -inf guards and
  the 1e-30 clamp on l);
* decode: a slot is valid when slot <= pos; ``window`` changes only the
  ring layout of the cache, never the mask (once pos >= Lc every slot is
  valid).

All scores, the softmax and P.V run in fp32; outputs are in q's dtype.
These run on any device; the CUDA kernels in ``kernel.py`` are held against
them.  ``flash_attention_fwd`` and ``flash_attention_bwd`` are the plain
versions of the training forward (output and row log-sum-exp) and of the
backward kernels; the tests hold them against autograd of
``chunked_attention``.
"""
from __future__ import annotations

import torch


def _gqa_expand(q, kv_heads):
    """(B,S,H,D) -> (B,S,KV,G,D) with G = H // KV."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, d)


def naive_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Direct attention. q:(B,Sq,H,D) k,v:(B,Sk,KV,D) -> (B,Sq,H,D)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qh = _gqa_expand(q, kvh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qh, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, chunk=512,
                      scale=None):
    """Flash-style attention: a loop over KV chunks with running (m, l, acc).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D); q aligned to the end of k.
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    chunk = min(chunk, sk)
    qh = _gqa_expand(q, kvh).float() * scale
    qpos = torch.arange(sq, device=dev) + (sk - sq)
    m = torch.full((b, kvh, g, sq), float("-inf"), device=dev)
    l = torch.zeros((b, kvh, g, sq), device=dev)
    acc = torch.zeros((b, kvh, g, sq, d), device=dev)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        kpos = torch.arange(c0, c0 + kb.shape[1], device=dev)
        s = torch.einsum("bskgd,btkd->bkgst", qh, kb)
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                             m_new)
        p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
        corr = torch.exp(torch.where(torch.isinf(m),
                                     torch.full_like(m, float("-inf")),
                                     m - m_safe))
        corr = torch.nan_to_num(corr, nan=0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


def _prefill_mask(sq, sk, causal, window, device):
    """(Sq, Sk) bool: the keys each query may see, queries aligned to the
    end of the keys."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_attention_fwd(q, k, v, *, causal=True, window=0, scale=None):
    """The training forward the kernel runs: (out in q's dtype, lse), lse
    the natural log-sum-exp of each row's scaled scores, fp32 (B, H, Sq),
    -inf for a row with no valid key (whose output is 0)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qh = _gqa_expand(q, kvh).float()
    s = torch.einsum("bskgd,btkd->bkgst", qh, k.float()) * scale
    s = s.masked_fill(~_prefill_mask(sq, sk, causal, window, q.device),
                      float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                       # (B,KV,G,Sq)
    lse_safe = torch.where(torch.isinf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - lse_safe[..., None])                 # -inf -> 0
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return (out.reshape(b, sq, h, d).to(q.dtype),
            lse.reshape(b, h, sq))


def flash_attention_bwd(q, k, v, lse, do, *, causal=True, window=0,
                        scale=None, kernel_order=False):
    """The gradients of attention in q, k and v, computed as the backward
    kernels do, all in fp32: P = exp(scale q.k - lse), 0 where masked;
    dP = dO.v; delta = rowsum(P dP) (softmax's own backward term, as
    autograd computes it); dS = P (dP - delta); dV = P^T dO and dK =
    scale dS^T q, each summed over the G query heads of its KV head; dQ =
    scale dS k.  q, do: (B, Sq, H, D); k, v: (B, Sk, KV, D); lse: fp32
    (B, H, Sq).  Returns (dq, dk, dv) in q's dtype.

    ``kernel_order=True`` is the tensor-core kernels' arithmetic (the bf16
    and fp16 ones): delta summed a 64-key tile at a time in key order, and
    P and dS (from fp32 P, dP and delta) rounded to q's dtype before the
    three products they feed; every sum stays fp32.  In fp32 it differs
    from the default only in summation order."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qh = _gqa_expand(q, kvh).float()                       # (B,Sq,KV,G,D)
    doh = _gqa_expand(do, kvh).float()
    kf, vf = k.float(), v.float()
    lse = lse.reshape(b, kvh, g, sq)
    mask = _prefill_mask(sq, sk, causal, window, q.device)
    s = torch.einsum("bskgd,btkd->bkgst", qh, kf)
    lse_safe = torch.where(torch.isinf(lse), torch.zeros_like(lse), lse)
    p = torch.where(mask, torch.exp(s * scale - lse_safe[..., None]),
                    torch.zeros((), device=q.device))
    del s
    dp = torch.einsum("bskgd,btkd->bkgst", doh, vf)
    if kernel_order:
        delta = torch.zeros(p.shape[:-1], device=q.device)
        for t0 in range(0, sk, 64):
            delta = delta + (p[..., t0:t0 + 64] * dp[..., t0:t0 + 64]
                             ).sum(-1)
    else:
        delta = (p * dp).sum(-1)                           # (B,KV,G,Sq)
    ds = p * (dp - delta[..., None])
    del dp
    if kernel_order:
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bkgst,bskgd->btkd", p, doh)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qh) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def decode_attention(q, k_cache, v_cache, pos, *, window=0, scale=None):
    """Single-token decode over a (possibly ring-buffered) cache.

    q: (B, 1, H, D); caches: (B, Lc, KV, D); pos: int or (B,) int tensor,
    the absolute position of the current token.  Valid slots are
    arange(Lc) <= pos.
    """
    b, _, h, d = q.shape
    lc, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qh = _gqa_expand(q, kvh)[:, 0].float() * scale            # (B,KV,G,D)
    s = torch.einsum("bkgd,btkd->bkgt", qh, k_cache.float())
    pos_b = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    valid = torch.arange(lc, device=q.device)[None, :] <= pos_b[:, None]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_split(q, k_cache, v_cache, pos, n_split, *, tile=16,
                           scale=None):
    """``decode_attention`` as the decode kernel computes it: the cache is
    cut into ``n_split`` runs of whole ``tile``-slot tiles
    (ceil(ntiles / n_split) tiles each; runs past the cache or wholly past
    ``pos`` are empty), each run gives a partial (m, l, acc) over its valid
    slots, and the partials are merged in run order.  Same arguments and
    mask as ``decode_attention``."""
    b, _, h, d = q.shape
    lc, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qh = _gqa_expand(q, kvh)[:, 0].float() * scale            # (B,KV,G,D)
    s = torch.einsum("bkgd,btkd->bkgt", qh, k_cache.float())
    pos_b = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    valid = torch.arange(lc, device=q.device)[None, :] <= pos_b[:, None]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    vf = v_cache.float()
    ntiles = -(-lc // tile)
    span = tile * -(-ntiles // n_split)                       # slots a run
    m_all = torch.full(s.shape[:3], float("-inf"), device=q.device)
    parts = []
    for z in range(n_split):
        sz = s[..., z * span:(z + 1) * span]
        if sz.shape[-1] == 0:                                 # past the cache
            m = torch.full(s.shape[:3], float("-inf"), device=q.device)
            parts.append((m, torch.zeros_like(m), torch.zeros_like(qh)))
            continue
        m = sz.amax(-1)
        m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(sz - m_safe[..., None])                 # -inf -> 0
        acc = torch.einsum("bkgt,btkd->bkgd", p,
                           vf[:, z * span:(z + 1) * span])
        parts.append((m, p.sum(-1), acc))
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros_like(m_all)
    out = torch.zeros_like(qh)
    for m, l, acc in parts:                                   # in run order
        w = torch.where(torch.isinf(m), torch.zeros_like(m),
                        torch.exp(m - m_all))
        l_all = l_all + l * w
        out = out + acc * w[..., None]
    out = out / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           logical_len, window=0, scale=None):
    """Single-token decode over a block-paged cache.

    k/v_pages: (NB_phys, BS, KV, D); block_tables: (B, nb) int physical ids
    (garbage-padded); logical_len: the true logical cache length (the ring
    modulus when window > 0).  Gathers the logical view and reuses
    ``decode_attention``'s masking.
    """
    b = q.shape[0]
    nb = block_tables.shape[1]
    bs = k_pages.shape[1]
    bt = block_tables.long()
    kc = k_pages[bt].reshape(b, nb * bs, *k_pages.shape[2:])[:, :logical_len]
    vc = v_pages[bt].reshape(b, nb * bs, *v_pages.shape[2:])[:, :logical_len]
    return decode_attention(q, kc, vc, pos, window=window, scale=scale)
