"""Wrapper of the hand-written CUDA fused SIL-MSE kernel (``csrc/sil_mse.cu``).

``sil_mse_cuda(act, sil, labels) -> (loss, grad)`` replaces
``sil_mse_fwd_tpu`` (``src/repro/kernels/sil_mse/kernel.py:81``, its
``pallas_call`` at :108; the loss-only wrapper ``sil_mse_tpu`` is :122).  It
checks device, dtype, shapes and strides and raises on what the kernel does
not take, allocates the grad and the loss, launches one kernel on PyTorch's
current stream without synchronising, raises if the launch reported a CUDA
error, and adds one to ``dispatch.LAUNCHES["sil_mse"]``.

The labels are not checked against [0, M) here, since that would wait for
the card; the kernel guards the index itself and answers an out-of-range
label with a NaN loss and a NaN grad row.  The kernel is bound by bytes; the
source file says how its design answers that.

``sil_plan`` is the kernel's decomposition (columns a unit, lanes a row,
rows a block, the grid), a pure function of the shapes, the 16-byte
decision and the SM count, and the launch uses it.  ``vector_loads``
decides from the tensors' addresses and strides whether the 16-byte path
can run.  The kernel's loss reduction keeps a ticket counter and one
partial a block in a workspace kept per (device, stream) (``_workspace``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES

SOURCE = "sil_mse"
# threads a block, units a lane loads before their first use, and the
# workspace's words before the partials (the ticket counter, padded)
THREADS, UNITS, WS_HEAD = build.source_constants(SOURCE, "THREADS", "UNITS",
                                                 "WS_HEAD")
# the grid's cap: the kernel's launch bounds keep two blocks an SM resident
BLOCKS_PER_SM = 2
VEC_BYTES = 16                  # one load of act on the vector path
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_INT64 = {torch.int32: 0, torch.int64: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class SilPlan:
    """How ``sil_mse_kernel`` cuts a (T, d) call: thread ``i`` of block
    ``b`` moves units ``i % lanes``, ``+ lanes``, ... of rows
    ``(b + k * blocks) * rows + i // lanes``, k = 0, 1, ...; a unit is
    ``cols`` columns (16 bytes of act on the vector path, one column
    otherwise)."""
    cols: int             # columns a unit
    lanes: int            # lanes a row: a power of two, at most a warp
    rows: int             # rows a block holds at once: THREADS // lanes
    per_lane: int         # units a lane moves in a row
    blocks: int           # the grid, and the partials of the loss

    @property
    def vector(self) -> bool:
        return self.cols > 1

    @property
    def lane_shift(self) -> int:
        return self.lanes.bit_length() - 1


@functools.lru_cache(maxsize=64)
def sil_plan(t: int, d: int, item: int, vector: bool, sms: int) -> SilPlan:
    """The plan of a (T, d) call with act of ``item`` bytes an element, on
    the 16-byte path or not, on a card of ``sms`` SMs.  Lanes a row follow
    the row's units up to a warp; the grid is at most ``BLOCKS_PER_SM *
    sms`` blocks, with the rows spread evenly over them."""
    cols = VEC_BYTES // item if vector else 1
    units = d // cols
    lanes = min(32, 1 << (units - 1).bit_length())
    rows = THREADS // lanes
    groups = -(-t // rows)
    per_block = -(-groups // (BLOCKS_PER_SM * sms))
    return SilPlan(cols=cols, lanes=lanes, rows=rows,
                   per_lane=-(-units // lanes),
                   blocks=-(-groups // per_block))


def vector_loads(act, sil) -> bool:
    """True where every unit is one aligned 16-byte load of act and of the
    table: act starts on 16 bytes with a row stride of whole 16 bytes, d is
    a multiple of the unit, and the table's (d, M) view has contiguous
    columns (the (M, d) layout) starting on 16 bytes with a column stride
    of whole 16 bytes."""
    cols = VEC_BYTES // act.element_size()
    t, d = act.shape
    return (d % cols == 0 and act.data_ptr() % VEC_BYTES == 0
            and (t == 1 or act.stride(0) % cols == 0)
            and sil.stride(0) == 1 and sil.data_ptr() % VEC_BYTES == 0
            and (sil.shape[1] == 1 or sil.stride(1) % 4 == 0))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> int32 workspace: the ticket counter, which every
# launch leaves at zero, then one fp32 partial a block
_WORKSPACES: dict = {}


def _workspace(index: int, stream: int) -> torch.Tensor:
    """The kernel's reduction workspace on ``stream`` of device ``index``:
    allocated (zeroed) once per (device, stream) for the largest grid a plan
    gives on that device, so a call allocates nothing for it; one per
    stream, because two streams running the kernel at once would share a
    ticket."""
    ws = _WORKSPACES.get((index, stream))
    if ws is None:
        ws = _WORKSPACES[(index, stream)] = torch.zeros(
            WS_HEAD + BLOCKS_PER_SM * _sm_count(index), dtype=torch.int32,
            device=torch.device("cuda", index))
    return ws


@functools.cache
def _launcher():
    """The typed C entry point, looked up once."""
    fn = build.load(SOURCE).repro_sil_mse
    fn.argtypes = [_P, _L, _P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _P]
    fn.restype = _I
    return fn


def _checks(act, sil, labels):
    if not act.is_cuda:
        raise ValueError(f"sil_mse: act must be a CUDA tensor, got "
                         f"{act.device}")
    dev = act.get_device()
    if sil.get_device() != dev or labels.get_device() != dev:
        raise ValueError(f"sil_mse: act, sil and labels must all be on "
                         f"{act.device}")
    if act.dtype not in _BF16:
        raise ValueError(f"sil_mse: act dtype {act.dtype} is not float32 or "
                         "bfloat16")
    if sil.dtype != torch.float32:
        raise ValueError(f"sil_mse: the SIL table must be float32, got "
                         f"{sil.dtype}")
    if labels.dtype not in _INT64:
        raise ValueError(f"sil_mse: labels dtype {labels.dtype} is not int32 "
                         "or int64")
    if act.dim() != 2 or sil.dim() != 2 or labels.dim() != 1:
        raise ValueError("sil_mse: act (T, d), sil (d, M), labels (T,)")
    t, d = act.shape
    if sil.shape[0] != d or labels.shape[0] != t:
        raise ValueError(f"sil_mse: act {tuple(act.shape)}, sil "
                         f"{tuple(sil.shape)}, labels {tuple(labels.shape)}")
    if t == 0 or d == 0 or sil.shape[1] == 0:
        raise ValueError("sil_mse: empty act or SIL table")
    if d > 1 and act.stride(1) != 1:
        raise ValueError("sil_mse: act's columns must be contiguous")
    if t > 1 and labels.stride(0) != 1:
        raise ValueError("sil_mse: labels must be contiguous")


def _plan(act, sil, index: int) -> SilPlan:
    t, d = act.shape
    return sil_plan(t, d, act.element_size(), vector_loads(act, sil),
                    _sm_count(index))


def _launch(act, sil, labels, grad, loss, plan, stream, ws) -> int:
    (s_act, _), (s_d, s_m) = act.stride(), sil.stride()
    t, d = act.shape
    return _launcher()(
        act.data_ptr(), s_act, sil.data_ptr(), s_d, s_m, labels.data_ptr(),
        grad.data_ptr(), loss.data_ptr(), ws.data_ptr(),
        _BF16[act.dtype] | _INT64[labels.dtype] << 1 | plan.vector << 2, t,
        d, sil.shape[1], plan.lane_shift, plan.blocks, stream)


def sil_mse_cuda(act: torch.Tensor, sil: torch.Tensor, labels: torch.Tensor):
    """act: (T, d) fp32/bf16, columns contiguous; sil: (d, M) fp32, any
    strides; labels: (T,) int32/int64.  Returns the fp32 scalar mean loss
    and dloss/dact (T, d) in act's dtype, in one pass and one launch.

    Each host step is the cheapest form measured on the card's host
    (``chip_smoke.sil_host_split``): the grad by ``empty_like``, the loss by
    ``new_empty``, the stream as its raw handle (no ``Stream`` object), and
    a device guard only where act is not on the current device."""
    _checks(act, sil, labels)
    index = act.get_device()
    plan = _plan(act, sil, index)
    grad = torch.empty_like(act, memory_format=torch.contiguous_format)
    loss = act.new_empty((), dtype=torch.float32)
    stream = torch._C._cuda_getCurrentRawStream(index)
    ws = _workspace(index, stream)
    if index == torch.cuda.current_device():
        err = _launch(act, sil, labels, grad, loss, plan, stream, ws)
    else:                       # the stream is another device's
        with torch.cuda.device(index):
            err = _launch(act, sil, labels, grad, loss, plan, stream, ws)
    build.check(err, "sil_mse kernel")
    LAUNCHES.add("sil_mse")
    return loss, grad
