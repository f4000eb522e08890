"""Dispatching attention: the CUDA kernels for CUDA tensors, the plain
PyTorch versions in ``ref.py`` for CPU tensors (``dispatch.decide``).
Same arguments as ``repro/kernels/flash_attention/ops.py``.

The prefill kernel has no backward yet, so ``flash_attention`` refuses a
CUDA input that requires grad under grad mode (``dispatch.refuse_grad``)
instead of returning an output without a ``grad_fn``; the CPU path keeps its
autograd.  The two decode kernels have no such check: no path hands them a
tensor that needs a gradient (decoding serves, it does not train)."""
from __future__ import annotations

from repro_torch.kernels.dispatch import KERNEL, decide, refuse_grad

from . import kernel, ref


def flash_attention(q, k, v, *, causal=True, window=0, chunk=512):
    """Training/prefill attention. q:(B,S,H,D) k,v:(B,S,KV,D); scores and
    softmax in fp32, output in q's dtype."""
    if decide("flash_attention", q) == KERNEL:
        refuse_grad("flash_attention", (q, k, v), "ROADMAP queue B row 1")
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
