"""Dispatching attention: the CUDA kernels for CUDA tensors, the plain
PyTorch versions in ``ref.py`` for CPU tensors (``dispatch.decide``).
Same arguments as ``repro/kernels/flash_attention/ops.py``.

On its kernel branch ``flash_attention`` is differentiable: where grad mode
is on and an input requires grad, it runs ``_FlashAttention``, a
``torch.autograd.Function`` whose forward is the prefill kernel with its
row log-sum-exp and whose backward is the backward kernel
(``kernel.flash_attention_bwd_cuda``), the gradient JAX takes of
``ref.chunked_attention``.  Otherwise (serving, ``torch.no_grad()``) it
calls the prefill kernel alone, without the log-sum-exp.  The CPU path
keeps the plain version's own autograd.  The two decode kernels have no
backward: no path hands them a tensor that needs a gradient (decoding
serves, it does not train)."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import KERNEL, decide

from . import kernel, ref


class _FlashAttention(torch.autograd.Function):
    """Prefill kernel forward (its inputs and lse saved), backward
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd_cuda(
            q, k, v, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=0, chunk=512):
    """Training/prefill attention. q:(B,S,H,D) k,v:(B,S,KV,D); scores and
    softmax in fp32, output in q's dtype."""
    if decide("flash_attention", q) == KERNEL:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _FlashAttention.apply(q, k, v, bool(causal), int(window))
        return kernel.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
    return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk)


def decode_attention(q, k_cache, v_cache, pos, *, window=0):
    """Single-token decode over a KV cache (ring-buffered if window>0)."""
    if decide("decode_attention", q) == KERNEL:
        return kernel.decode_attention_cuda(q, k_cache, v_cache, pos,
                                            window=window)
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window)


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           logical_len, window=0):
    """Single-token decode gathering K/V through a per-request block table
    (k/v_pages: (NB_phys, BS, KV, D); block_tables: (B, nb))."""
    if decide("paged_decode_attention", q) == KERNEL:
        return kernel.paged_decode_attention_cuda(
            q, k_pages, v_pages, block_tables, pos,
            logical_len=logical_len, window=window)
    return ref.paged_decode_attention(
        q, k_pages, v_pages, block_tables, pos,
        logical_len=logical_len, window=window)
