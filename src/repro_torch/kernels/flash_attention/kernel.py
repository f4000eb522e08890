"""Wrappers of the hand-written CUDA attention kernels (``csrc/flash_attention.cu``).

Each wrapper checks device, dtype, shape and strides, raises on what the
kernel does not take, allocates the output, launches on PyTorch's current
stream without synchronising, raises if the launch reported a CUDA error,
and adds one to its family's count in ``dispatch.LAUNCHES``.

Replaces (``src/repro/kernels/flash_attention/kernel.py``):

* ``flash_attention_cuda``        <- ``flash_attention_tpu`` (:196)
* ``decode_attention_cuda``       <- ``decode_attention_tpu`` (:275)
* ``paged_decode_attention_cuda`` <- ``paged_decode_attention_tpu`` (:329)

Prefill is bound by operations for long prompts, both decodes by the bytes
of the K/V cache; the source file says how each design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES

SOURCE = "flash_attention"
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8          # query heads per KV head in one decode block
PAGE_TILE = 16         # decode tile == the paged block size the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        lib.repro_fa_prefill.argtypes = ([_P] * 4 + [_I] * 7 + [_L] * 12
                                         + [_I, _I, _F, _P])
        lib.repro_fa_prefill.restype = _I
        lib.repro_fa_decode.argtypes = ([_P] * 6 + [_I] * 7 + [_L] * 4
                                        + [_F, _P])
        lib.repro_fa_decode.restype = _I
        lib._repro_typed = True
    return lib


def _check_common(name, q, tensors, head_dim):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must be a CUDA tensor, got {q.device}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: dtype mismatch {t.dtype} vs {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {head_dim} not in {HEAD_DIMS}")


def _pos_vector(pos, b, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        if pos.device != device:
            raise ValueError(f"pos must be on {device}, got {pos.device}")
        return pos.to(torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_cuda(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype.
    Any strides with a contiguous head dim; queries aligned to the end of
    the keys."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B,Sq,H,D), k=v (B,Sk,KV,D)")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    if window < 0:
        raise ValueError("flash_attention: window must be >= 0")
    _check_common("flash_attention", q, (k, v), d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _lib().repro_fa_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, sq, sk, h, kv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(bool(causal)), int(window), d ** -0.5, _stream(q.device))
    build.check(err, "flash_attention kernel")
    LAUNCHES.add("flash_attention")
    return out


def _decode_checks(name, q, k, v, g):
    if q.dim() != 4 or q.shape[1] != 1 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be a contiguous (B, 1, H, D)")
    if k.dim() != 4 or v.shape != k.shape or v.stride() != k.stride():
        raise ValueError(f"{name}: k and v must share shape and strides")
    if q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache "
                         f"{tuple(k.shape)}")
    if g > MAX_GROUP:
        raise ValueError(f"{name}: {g} query heads per KV head > {MAX_GROUP}")
    _check_common(name, q, (k, v), q.shape[3])


def decode_attention_cuda(q, k_cache, v_cache, pos, *, window=0):
    """q: (B, 1, H, D); caches: (B, Lc, KV, D); pos: int or (B,) tensor.
    ``window`` sets the ring layout only, never the mask."""
    b, _, h, d = q.shape
    lc, kv = k_cache.shape[1], k_cache.shape[2]
    _decode_checks("decode_attention", q, k_cache, v_cache, h // kv)
    if k_cache.shape[0] != b:
        raise ValueError("decode_attention: cache batch != q batch")
    pos_b = _pos_vector(pos, b, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_fa_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), pos_b.data_ptr(), None, _DTYPE_CODE[q.dtype],
            b, h, kv, d, lc, 0, k_cache.stride(0), 0, k_cache.stride(1),
            k_cache.stride(2), d ** -0.5, _stream(q.device))
    build.check(err, "decode_attention kernel")
    LAUNCHES.add("decode_attention")
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, pos, *,
                                logical_len, window=0):
    """q: (B, 1, H, D); k/v_pages: (NB, 16, KV, D); block_tables: (B, nb)
    int physical block ids; mask ``slot < logical_len & slot <= pos``."""
    b, _, h, d = q.shape
    kv = k_pages.shape[2]
    _decode_checks("paged_decode_attention", q, k_pages, v_pages, h // kv)
    if k_pages.shape[1] != PAGE_TILE:
        raise ValueError(f"paged_decode_attention: block size "
                         f"{k_pages.shape[1]} != {PAGE_TILE}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("paged_decode_attention: block_tables (B, nb)")
    nb = block_tables.shape[1]
    if not 0 < logical_len <= nb * PAGE_TILE:
        raise ValueError(f"paged_decode_attention: logical_len {logical_len}"
                         f" outside (0, {nb * PAGE_TILE}]")
    if block_tables.device != q.device:
        raise ValueError("paged_decode_attention: block_tables on "
                         f"{block_tables.device}, q on {q.device}")
    bt = block_tables.to(torch.int32).contiguous()
    pos_b = _pos_vector(pos, b, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_fa_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), pos_b.data_ptr(), bt.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, kv, d, int(logical_len), nb, 0,
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            d ** -0.5, _stream(q.device))
    build.check(err, "paged_decode_attention kernel")
    LAUNCHES.add("paged_decode_attention")
    return out
