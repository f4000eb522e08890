"""Wrappers of the hand-written CUDA attention kernels (``csrc/flash_attention.cu``).

Each wrapper checks device, dtype, shape and strides, raises on what the
kernel does not take, allocates the output, launches on PyTorch's current
stream without synchronising, raises if the launch reported a CUDA error,
and adds one to its family's count in ``dispatch.LAUNCHES``.

Replaces (``src/repro/kernels/flash_attention/kernel.py``):

* ``flash_attention_cuda``        <- ``flash_attention_tpu`` (:196)
* ``flash_attention_bwd_cuda``    <- the gradient JAX takes of it (the Pallas
  kernel has no ``custom_vjp``; on the CPU JAX differentiates
  ``ref.chunked_attention``)
* ``decode_attention_cuda``       <- ``decode_attention_tpu`` (:275)
* ``paged_decode_attention_cuda`` <- ``paged_decode_attention_tpu`` (:329)

Prefill is bound by operations for long prompts, both decodes by the bytes
of the K/V cache; the source file says how each design answers that.

Prefill dispatches by dtype between two hand-written kernels: bf16 and fp16
run the tensor-core kernel (``wgmma`` fed by TMA), which reads q, k, v and
writes the output through tensor maps, so each must start 16-byte aligned
with every stride a multiple of 16 bytes (``ValueError`` otherwise); fp32
runs the CUDA-core kernel, since the tensor cores' only fp32 mode (TF32)
keeps about three decimal digits.  With ``return_lse=True`` (the training
forward) the prefill also writes each row's log-sum-exp, which the backward
reads; the serve path passes none.  The backward (``flash_attention_bwd_cuda``,
two launches: dQ and softmax's delta a query tile, then dK/dV a key tile;
``bwd_plan`` says how they cut the work) dispatches the same way: bf16 and
fp16 run the tensor-core kernels, which read q, k, v and dO through tensor
maps, so q, k and v must meet the same 16-byte rule (``ValueError``
otherwise) and a ``do`` that does not (autograd may hand one over) is
copied; fp32 runs the CUDA-core kernels at any strides with a contiguous
head dim.  Both take head dims 64, 80 and 128.  A head dim of 80 is read
in whole 64-column boxes, the last one zero-filled past column 80 by the
tensor maps themselves: no input is padded or copied for it.  Decode
splits the cache into ``split_plan`` runs of whole 16-slot tiles, one block
each, carrying all the query heads of a KV head (at most ``MAX_GROUP``),
and merges the partials in the same launch (see ``_decode_workspace``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES

SOURCE = "flash_attention"
HEAD_DIMS = (64, 80, 128, 256)
BWD_HEAD_DIMS = (64, 80, 128)   # the backward's 64-row fp32 tiles of D 256
                                # would not fit in a block's shared memory
# query rows and keys a backward tile, and the consumer warpgroups of a dQ
# block (a tile of rows each) and of a dK/dV block (the group's heads split
# between them), as the kernels define them
BWD_TILE, BWD_DQ_WGS, BWD_DKDV_WGS = build.source_constants(
    SOURCE, "TB", "BWD_DQ_WGS", "BWD_DKDV_WGS")
# query heads per KV head in one decode block, which also sizes the (m, l)
# floats of a split's partial in the workspace
MAX_GROUP, = build.source_constants(SOURCE, "MAX_GROUP")
PAGE_TILE = 16         # decode tile == the paged block size the kernel takes
# decode blocks wanted in flight: two for each of the H100's 132 SMs (and
# so at most 264 splits, the kernel's MAX_SPLIT)
DECODE_BLOCKS = 2 * 132
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        lib.repro_fa_prefill.argtypes = ([_P] * 5 + [_I] * 7 + [_L] * 12
                                         + [_I, _I, _F, _P])
        lib.repro_fa_prefill.restype = _I
        lib.repro_fa_backward.argtypes = ([_P] * 9 + [_I] * 7 + [_L] * 12
                                          + [_I, _I, _F, _P])
        lib.repro_fa_backward.restype = _I
        lib.repro_fa_decode.argtypes = ([_P] * 8 + [_I] * 9 + [_L] * 4
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


def _tma_strides(name, t):
    """(batch, seq, head) element strides of a (B, S, heads, D) bf16/fp16
    tensor for its tensor map.  TMA needs a 16-byte aligned base and strides
    that are multiples of 16 bytes; a dim of size 1 is never stepped, so its
    stride is replaced by one that is."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: a {t.dtype} input must start 16-byte "
                         "aligned (TMA)")
    out = []
    for n, st in zip(t.shape[:3], t.stride()[:3]):
        if n == 1:
            st = t.shape[3]
        elif (st * t.element_size()) % 16:
            raise ValueError(f"{name}: {t.dtype} strides {t.stride()} are not"
                             " all multiples of 16 bytes (TMA)")
        out.append(st)
    return out


def _pos_vector(pos, b, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        if pos.device != device:
            raise ValueError(f"pos must be on {device}, got {pos.device}")
        return pos.to(torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _attention_shapes(name, q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q (B,Sq,H,D), k=v (B,Sk,KV,D)")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0")
    return b, sq, sk, h, kv, d


def flash_attention_cuda(q, k, v, *, causal=True, window=0,
                         return_lse=False):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype.
    Any strides with a contiguous head dim; queries aligned to the end of
    the keys.  With ``return_lse`` also the rows' natural log-sum-exp of the
    scaled scores, fp32 (B, H, Sq), -inf for a row with no valid key:
    ``(out, lse)``."""
    b, sq, sk, h, kv, d = _attention_shapes("flash_attention", q, k, v,
                                            window)
    _check_common("flash_attention", q, (k, v), d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.dtype == torch.float32:
        strides = [x.stride()[:3] for x in (q, k, v, out)]
    else:
        strides = [_tma_strides("flash_attention", x) for x in (q, k, v, out)]
    with torch.cuda.device(q.device):
        err = _lib().repro_fa_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, sq, sk, h, kv, d,
            *[st for x in strides for st in x],
            int(bool(causal)), int(window), d ** -0.5, _stream(q.device))
    build.check(err, "flash_attention kernel")
    LAUNCHES.add("flash_attention")
    return (out, lse) if return_lse else out


def _tma_ok(t) -> bool:
    """Whether a (B, S, heads, D) tensor meets TMA's 16-byte rule (see
    ``_tma_strides``)."""
    return t.data_ptr() % 16 == 0 and t.stride(-1) == 1 and all(
        (st * t.element_size()) % 16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def flash_attention_bwd_cuda(q, k, v, lse, do, *, causal=True, window=0):
    """The gradients of ``flash_attention_cuda`` in q, k and v: dq
    (B, Sq, H, D) and dk, dv (B, Sk, KV, D), contiguous, in q's dtype with
    fp32 accumulation, from its inputs, its ``lse`` and the output's
    gradient ``do`` (q's shape).  The output itself is not read: softmax's
    backward term is rowsum(P dP), as autograd computes it.  bf16 and fp16
    run on the tensor cores, with P and dS rounded to q's dtype for the
    three products they feed (``ref.flash_attention_bwd(...,
    kernel_order=True)`` is that arithmetic); q, k and v must then start
    16-byte aligned with strides of multiples of 16 bytes (``ValueError``
    otherwise), and a ``do`` that does not is copied.  fp32 runs on the CUDA
    cores and reads every input at its own strides; only a ``do`` whose head
    dim is not contiguous is copied.  Two calls on the same inputs are
    bitwise equal."""
    name = "flash_attention_bwd"
    b, sq, sk, h, kv, d = _attention_shapes(name, q, k, v, window)
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {BWD_HEAD_DIMS}")
    tma = q.dtype != torch.float32
    if do.stride(-1) != 1 or (tma and not _tma_ok(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    _check_common(name, q, (k, v, do), d)
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} must be q's "
                         f"{tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or lse.shape != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be a contiguous fp32 (B, H, Sq) "
                         f"on {q.device}")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if tma:
        strides = [_tma_strides(name, x) for x in (q, k, v, do)]
    else:
        strides = [x.stride()[:3] for x in (q, k, v, do)]
    # softmax's rowsum(P dP), written by the dQ kernel for the dK/dV one
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().repro_fa_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), _DTYPE_CODE[q.dtype], b, sq, sk,
            h, kv, d, *[st for x in strides for st in x],
            int(bool(causal)), int(window), d ** -0.5, _stream(q.device))
    build.check(err, f"{name} kernel")
    LAUNCHES.add(name)
    return dq, dk, dv


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the bf16/fp16 backward kernels cut one (batch, KV group): the
    same formulas as ``attn_bwd_dq_wgmma_kernel`` and
    ``attn_bwd_dkdv_wgmma_kernel``, in their launch order.

    ``dq_blocks[y]`` is (query block, key tiles) of the dQ block with
    blockIdx.y = y: it holds ``BWD_DQ_WGS`` query tiles of ``BWD_TILE`` rows
    and streams the key tiles twice; warpgroup w of it computes key tile kt
    unless ``dq_skips(query tile, kt)``.  ``dkdv_blocks[y]`` is (key tile,
    query tiles) of the dK/dV block with blockIdx.y = y; its warpgroup w
    walks, for each head g of ``heads[w]`` in turn, those query tiles."""
    sq: int
    sk: int
    causal: bool
    window: int
    dq_blocks: tuple
    dkdv_blocks: tuple
    heads: tuple

    def dq_skips(self, qt: int, kt: int) -> bool:
        qlo = qt * BWD_TILE + self.sk - self.sq
        k0 = kt * BWD_TILE
        return bool((self.causal and k0 > qlo + BWD_TILE - 1)
                    or (self.window and k0 + BWD_TILE - 1
                        <= qlo - self.window))


def bwd_plan(sq: int, sk: int, h: int, kv: int, *, causal: bool,
             window: int) -> BwdPlan:
    t, rows, off = BWD_TILE, BWD_TILE * BWD_DQ_WGS, sk - sq
    nqb, nkt, g = -(-sq // rows), -(-sk // t), h // kv
    dq_blocks = []
    for y in range(nqb):
        q0 = (nqb - 1 - y) * rows              # the longest block first
        end = nkt
        if causal:
            maxq = min(q0 + rows, sq) - 1 + off
            end = 0 if maxq < 0 else min(end, maxq // t + 1)
        lo = q0 + off - window + 1
        begin = lo // t if window and lo > 0 else 0
        dq_blocks.append((q0 // rows, range(begin, max(begin, end))))
    dkdv_blocks = []
    for kt in range(nkt):                      # the longest block first
        k0, begin, end = kt * t, 0, -(-sq // t)
        if causal and k0 - off > 0:
            begin = (k0 - off) // t
        if window:
            last = k0 + t - 1 + window - 1 - off
            end = 0 if last < 0 else min(end, last // t + 1)
        dkdv_blocks.append((kt, range(begin, max(begin, end))))
    heads = tuple(tuple(range(w, g, BWD_DKDV_WGS))
                  for w in range(BWD_DKDV_WGS))
    return BwdPlan(sq, sk, bool(causal), int(window), tuple(dq_blocks),
                   tuple(dkdv_blocks), heads)


def split_plan(lc: int, b: int, kv: int):
    """(tiles_per_split, n_split) of a decode over a cache of ``lc`` slots:
    whole 16-slot tiles, enough splits for ``DECODE_BLOCKS`` blocks while
    the cache has tiles for them.  A function of (lc, b, kv) alone, so a
    contiguous cache and a paged one of the same logical length are cut at
    the same places (paged equals contiguous bitwise)."""
    ntiles = max(1, -(-lc // PAGE_TILE))
    want = min(ntiles, max(1, -(-DECODE_BLOCKS // (b * kv))))
    per = -(-ntiles // want)
    return per, -(-ntiles // per)


# (device index, stream) -> (fp32 partials, int32 tickets)
_WORKSPACES: dict = {}


def _decode_workspace(device, stream, n_floats, n_counters):
    """The decode kernel's scratch: fp32 partials (m, l, acc) of every split
    and one ticket counter per (b, kv head), which the kernel leaves at zero.
    Allocated once per (device, stream) and grown when a launch needs more,
    so a decode step allocates nothing; one per stream, because two streams
    running decodes at once would share tickets and partials."""
    key = (device.index, stream)
    ws, cnt = _WORKSPACES.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _WORKSPACES[key] = (ws, cnt)
    return ws, cnt


def _launch_decode(name, q, k, v, pos_b, bt, lc, nb, s_b, s_page, s_l, s_kv):
    """One decode launch over ``lc`` logical slots (k, v the cache or the
    pages; ``bt`` the int32 block table or None)."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    if k.data_ptr() % 16 or v.data_ptr() % 16 or any(
            (st * k.element_size()) % 16 for n, st in zip(k.shape[:3],
                                                          k.stride()[:3])
            if n > 1):
        raise ValueError(f"{name}: the cache must start 16-byte aligned with "
                         f"strides of multiples of 16 bytes, got "
                         f"{k.stride()} (16-byte copies)")
    per, n_split = split_plan(lc, b, kv)
    out = torch.empty_like(q)
    stream = _stream(q.device)
    # per split: acc[G][D], then (m, l) in 2 * MAX_GROUP floats
    ws, cnt = _decode_workspace(
        q.device, stream, b * kv * n_split * ((h // kv) * d + 2 * MAX_GROUP),
        b * kv)
    with torch.cuda.device(q.device):
        err = _lib().repro_fa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos_b.data_ptr(), None if bt is None else bt.data_ptr(),
            ws.data_ptr(), cnt.data_ptr(), _DTYPE_CODE[q.dtype], b, h, kv, d,
            lc, nb, per, n_split, s_b, s_page, s_l, s_kv, d ** -0.5, stream)
    build.check(err, f"{name} kernel")
    LAUNCHES.add(name)
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
    return _launch_decode("decode_attention", q, k_cache, v_cache, pos_b,
                          None, lc, 0, k_cache.stride(0), 0,
                          k_cache.stride(1), k_cache.stride(2))


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
    return _launch_decode("paged_decode_attention", q, k_pages, v_pages,
                          pos_b, bt, int(logical_len), nb, 0,
                          k_pages.stride(0), k_pages.stride(1),
                          k_pages.stride(2))
