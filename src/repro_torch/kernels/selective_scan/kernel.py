"""Wrapper of the hand-written CUDA selective scan (``csrc/selective_scan.cu``).

``selective_scan_cuda(u, dt, A, B, C, D, h0=None) -> (y, h_last)`` replaces
``selective_scan_tpu`` (``src/repro/kernels/selective_scan/kernel.py:99``,
body ``_scan_kernel`` :65, ``pallas_call`` at :130).  It checks device,
dtypes, shapes and strides and raises on what the kernel does not take,
allocates y and h_last, launches on PyTorch's current stream without
synchronising, raises if the launch reported a CUDA error, and adds one to
``dispatch.LAUNCHES["selective_scan"]``.

u, dt, B and C may be strided views as long as their last dimension is
contiguous: the Mamba layer hands B and C over as column slices of
``x_proj``'s output (row stride ``dt_rank + 2N``) and the kernel reads them
in place, with no copy.  Unlike the TPU wrapper, a nonzero ``h0`` goes to the
kernel too.

The backward is two wrappers, which ``ops._SelectiveScan`` calls under grad:
``selective_scan_fwd_saving_cuda`` is the forward that also returns the
state entering every ``BWD_TILE`` steps (counted as a ``selective_scan``
launch), and ``selective_scan_bwd_cuda`` is the gradient JAX takes of the
scan (one call, two launches: the walk back and the second pass that adds
the partial sums in a fixed order; counted once as ``selective_scan_bwd``).
The source file says what bounds each kernel and how its design answers
that.

``scan_plan`` and ``bwd_plan`` are the kernels' decompositions (lanes a
channel, threads a block, the grid, the time tiles), pure functions of the
shapes, and the launches use their grids and threads.  Their tiling
constants are read from the CUDA source's ``constexpr`` lines, so the plans
and the kernels share one definition of them.  ``vector_loads`` decides
from the tensors' addresses and strides whether the tiles can be staged
with 16-byte copies.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES

SOURCE = "selective_scan"
STATE_SIZES = (4, 8, 16)        # N, a template parameter of the kernel
MAX_BATCH = 65535               # the grid's y dimension
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16                  # one cp.async copy
# a cap on the grid of the backward's second pass, which strides over the
# outputs beyond it
MAX_REDUCE_BLOCKS = 65535


# consecutive channels a block, time steps a staged tile, and the states of
# a channel a lane holds
CHANNELS, TILE, STATES_PER_LANE = build.source_constants(SOURCE, "CHANNELS",
                                                        "TILE", "QUAD")
# the backward: steps a staged tile (the saving forward's interval), steps a
# sub-tile held in registers, channels a thread
BWD_TILE, BWD_SUB, BWD_PAIR = build.source_constants(SOURCE, "BWD_TILE",
                                                     "SUB", "BWD_PAIR")
BWD_CHANNELS = 32 * BWD_PAIR    # a block: a warp's lanes of BWD_PAIR each
# threads a block of the backward's second pass
REDUCE_THREADS, = build.source_constants(SOURCE, "REDUCE_THREADS")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How ``scan_kernel`` cuts a (Ba, S, Di, N) scan: thread ``i`` of block
    (x, b) holds states ``(i // CHANNELS) * 4 .. + 3`` of channel
    ``x * CHANNELS + i % CHANNELS`` of batch row b (so a warp holds the same
    four states of 32 channels), and walks time in ``tiles`` tiles of
    ``TILE`` steps (the last one partial where S % TILE)."""
    lanes: int            # lanes a channel: N / 4
    threads: int          # a block: CHANNELS * lanes
    grid: tuple           # (ceil(Di / CHANNELS), Ba)
    tiles: int            # ceil(S / TILE)

    @property
    def warps(self) -> int:
        return self.grid[0] * self.grid[1] * self.threads // 32


def scan_plan(ba: int, s: int, di: int, n: int) -> ScanPlan:
    lanes = n // STATES_PER_LANE
    return ScanPlan(lanes=lanes, threads=CHANNELS * lanes,
                    grid=(-(-di // CHANNELS), ba), tiles=-(-s // TILE))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``scan_bwd_kernel`` cuts a (Ba, S, Di, N) backward: thread ``i``
    of block (x, b) holds states ``(i // 32) * 4 .. + 3`` of channels
    ``x * BWD_CHANNELS + BWD_PAIR * (i % 32) + k``, k < BWD_PAIR, of batch
    row b (so a warp holds the same four states of 64 channels), and walks
    ``tiles`` tiles of ``BWD_TILE`` steps from the last to the first, each
    as two sub-tiles of ``BWD_SUB`` steps (the last tile partial where
    S % BWD_TILE)."""
    lanes: int            # lanes a channel: N / 4
    threads: int          # a block: 32 * lanes
    grid: tuple           # (ceil(Di / BWD_CHANNELS), Ba)
    tiles: int            # ceil(S / BWD_TILE): also the states saved

    @property
    def warps(self) -> int:
        return self.grid[0] * self.grid[1] * self.threads // 32


def bwd_plan(ba: int, s: int, di: int, n: int) -> BwdPlan:
    lanes = n // STATES_PER_LANE
    return BwdPlan(lanes=lanes, threads=32 * lanes,
                   grid=(-(-di // BWD_CHANNELS), ba), tiles=-(-s // BWD_TILE))


def vector_loads(u, dt, B, C) -> bool:
    """True where every 16-byte copy of a tile row is aligned and lies
    wholly inside or wholly outside the channels: u, dt, B and C start on
    16 bytes, their batch and time strides are whole 16-byte units, and Di
    is a multiple of 8 (a chunk of bf16 u is 8 channels, of dt 4)."""
    if u.shape[-1] % 8:
        return False
    for t in (u, dt, B, C):
        per = VEC_BYTES // t.element_size()
        if t.data_ptr() % VEC_BYTES or any(
                t.shape[i] > 1 and t.stride(i) % per
                for i in range(t.dim() - 1)):
            return False
    return True


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        lib.repro_selective_scan.argtypes = [
            _P, _L, _L, _I, _P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _P,
            _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.repro_selective_scan.restype = _I
        lib.repro_selective_scan_bwd.argtypes = [
            _P, _L, _L, _I, _P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _P,
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _I, _I, _I, _I, _P]
        lib.repro_selective_scan_bwd.restype = _I
        lib.repro_selective_scan_bwd_occupancy.argtypes = [_I, _I, _I]
        lib.repro_selective_scan_bwd_occupancy.restype = _I
        lib._repro_typed = True
    return lib


def _last_dim_contiguous(t) -> bool:
    return t.shape[-1] <= 1 or t.stride(-1) == 1


def _checks(u, dt, A, B, C, D, h0):
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: u must be a CUDA tensor, got "
                         f"{u.device}")
    others = [dt, A, B, C, D] + ([h0] if h0 is not None else [])
    if any(t.device != u.device for t in others):
        raise ValueError(f"selective_scan: every tensor must be on "
                         f"{u.device}")
    if u.dtype not in _DTYPE_CODE:
        raise ValueError(f"selective_scan: u dtype {u.dtype} is not float32 "
                         "or bfloat16")
    if any(t.dtype != torch.float32 for t in others):
        raise ValueError("selective_scan: dt, A, B, C, D and h0 must be "
                         "float32")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError("selective_scan: u, dt (Ba, S, Di); A (Di, N); "
                         "B, C (Ba, S, N); D (Di,)")
    ba, s, di = u.shape
    n = A.shape[1]
    if (dt.shape != u.shape or A.shape[0] != di or B.shape != (ba, s, n)
            or C.shape != (ba, s, n) or D.shape != (di,)):
        raise ValueError(f"selective_scan: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)}")
    if h0 is not None and h0.shape != (ba, di, n):
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)}, expected "
                         f"{(ba, di, n)}")
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan: state size N={n} not in "
                         f"{STATE_SIZES}")
    if ba == 0 or di == 0:
        raise ValueError("selective_scan: empty batch or d_inner")
    if ba > MAX_BATCH:
        raise ValueError(f"selective_scan: batch {ba} > {MAX_BATCH}")
    if not all(_last_dim_contiguous(t) for t in (u, dt, B, C)):
        raise ValueError("selective_scan: the last dim of u, dt, B and C "
                         "must be contiguous")
    if not all(t.is_contiguous() for t in [A, D]
               + ([h0] if h0 is not None else [])):
        raise ValueError("selective_scan: A, D and h0 must be contiguous")


def _forward(u, dt, A, B, C, D, h0, save):
    _checks(u, dt, A, B, C, D, h0)
    ba, s, di = u.shape
    n = A.shape[1]
    plan = scan_plan(ba, s, di, n)
    y = torch.empty((ba, s, di), dtype=u.dtype, device=u.device)
    h_last = torch.empty((ba, di, n), dtype=torch.float32, device=u.device)
    states = torch.empty(states_shape(ba, s, di, n), dtype=torch.float32,
                         device=u.device) if save else None
    with torch.cuda.device(u.device):
        err = _lib().repro_selective_scan(
            u.data_ptr(), u.stride(0), u.stride(1), _DTYPE_CODE[u.dtype],
            dt.data_ptr(), dt.stride(0), dt.stride(1), A.data_ptr(),
            B.data_ptr(), B.stride(0), B.stride(1),
            C.data_ptr(), C.stride(0), C.stride(1), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), None if states is None else states.data_ptr(),
            ba, s, di, n, plan.grid[0], plan.threads,
            int(vector_loads(u, dt, B, C)),
            torch.cuda.current_stream(u.device).cuda_stream)
    build.check(err, "selective_scan kernel")
    LAUNCHES.add("selective_scan")
    return y, h_last, states


def states_shape(ba: int, s: int, di: int, n: int) -> tuple:
    """The saved states' buffer: the state entering each of the backward's
    tiles (every ``BWD_TILE`` steps), (Ba, tiles, N / 4, Di, 4) fp32, so a
    warp's 32 channels store 512 consecutive bytes."""
    return (ba, bwd_plan(ba, s, di, n).tiles, n // STATES_PER_LANE, di,
            STATES_PER_LANE)


def bwd_blocks_per_sm(dtype, n: int, vec: bool) -> int:
    """Blocks of the backward's walk an SM holds at once (the CUDA occupancy
    calculator, with the kernel's registers and shared memory)."""
    blocks = _lib().repro_selective_scan_bwd_occupancy(_DTYPE_CODE[dtype], n,
                                                       int(vec))
    if blocks < 0:
        raise RuntimeError("selective_scan_bwd: the occupancy query failed")
    return blocks


def selective_scan_cuda(u, dt, A, B, C, D, *, h0=None):
    """u: (Ba, S, Di) fp32/bf16; dt: (Ba, S, Di) fp32; A: (Di, N) fp32;
    B, C: (Ba, S, N) fp32; D: (Di,) fp32; h0: optional (Ba, Di, N) fp32.
    Returns (y (Ba, S, Di) in u's dtype, h_last (Ba, Di, N) fp32)."""
    y, h_last, _ = _forward(u, dt, A, B, C, D, h0, False)
    return y, h_last


def selective_scan_fwd_saving_cuda(u, dt, A, B, C, D, *, h0=None):
    """``selective_scan_cuda`` that also returns ``states``, the state
    entering every time tile (``states_shape``), which
    ``selective_scan_bwd_cuda`` reads.  The same kernel, launched once."""
    return _forward(u, dt, A, B, C, D, h0, True)


def selective_scan_bwd_cuda(u, dt, A, B, C, D, states, dy, *, dh_last=None,
                            want_dh0=False):
    """The scan's gradient.  u, dt, A, B, C, D as the forward took them,
    ``states`` from ``selective_scan_fwd_saving_cuda`` on them, dy (Ba, S,
    Di) in u's dtype (any strides: a non-contiguous one is copied), dh_last
    optional (Ba, Di, N) fp32.  Returns (du (u's dtype), ddt, dA, dB, dC,
    dD, dh0 or None), each contiguous: du, ddt (Ba, S, Di); dA (Di, N); dB,
    dC (Ba, S, N); dD (Di,); dh0 (Ba, Di, N) where ``want_dh0``.  Every
    gradient is accumulated in fp32."""
    _checks(u, dt, A, B, C, D, None)
    ba, s, di = u.shape
    n = A.shape[1]
    plan = bwd_plan(ba, s, di, n)
    dev = u.device
    if (states.dtype != torch.float32 or states.device != dev
            or tuple(states.shape) != states_shape(ba, s, di, n)
            or not states.is_contiguous()
            or states.data_ptr() % VEC_BYTES):
        raise ValueError(f"selective_scan_bwd: states must be contiguous, "
                         f"16-byte aligned fp32 {states_shape(ba, s, di, n)} "
                         f"on {dev}")
    if dy.shape != u.shape or dy.dtype != u.dtype or dy.device != dev:
        raise ValueError(f"selective_scan_bwd: dy must be {tuple(u.shape)} "
                         f"{u.dtype} on {dev}, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    if dh_last is not None and (
            dh_last.shape != (ba, di, n) or dh_last.dtype != torch.float32
            or dh_last.device != dev):
        raise ValueError(f"selective_scan_bwd: dh_last must be fp32 "
                         f"{(ba, di, n)} on {dev}")
    dy = dy.contiguous()
    dh_last = None if dh_last is None else dh_last.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((ba, s, di), dtype=u.dtype, device=dev)
    ddt = torch.empty((ba, s, di), **f32)
    dB = torch.empty((ba, s, n), **f32)
    dC = torch.empty((ba, s, n), **f32)
    dA = torch.empty((di, n), **f32)
    dD = torch.empty((di,), **f32)
    dh0 = torch.empty((ba, di, n), **f32) if want_dh0 else None
    # the partial sums the second pass adds: dB and dC per block of channels
    # (a quad of each a lane), dA and dD per batch row
    dbc_part = torch.empty((ba, s, plan.grid[0], plan.lanes,
                            2 * STATES_PER_LANE), **f32)
    da_part = torch.empty((ba, di, n), **f32)
    dd_part = torch.empty((ba, di), **f32)
    outputs = ba * s * 2 * n + di * n + di
    red_blocks = max(1, min(-(-outputs // REDUCE_THREADS), MAX_REDUCE_BLOCKS))
    with torch.cuda.device(dev):
        err = _lib().repro_selective_scan_bwd(
            u.data_ptr(), u.stride(0), u.stride(1), _DTYPE_CODE[u.dtype],
            dt.data_ptr(), dt.stride(0), dt.stride(1), A.data_ptr(),
            B.data_ptr(), B.stride(0), B.stride(1),
            C.data_ptr(), C.stride(0), C.stride(1), D.data_ptr(),
            states.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(),
            du.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dA.data_ptr(), dD.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), dbc_part.data_ptr(),
            da_part.data_ptr(), dd_part.data_ptr(), ba, s, di, n,
            plan.grid[0], plan.threads, red_blocks,
            int(vector_loads(u, dt, B, C) and dy.data_ptr() % VEC_BYTES == 0),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "selective_scan backward kernel")
    LAUNCHES.add("selective_scan_bwd")
    return du, ddt, dA, dB, dC, dD, dh0
