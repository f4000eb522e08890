"""Wrapper of the hand-written CUDA fused SIL-MSE kernel (``csrc/sil_mse.cu``).

``sil_mse_cuda(act, sil, labels) -> (loss, grad)`` replaces
``sil_mse_fwd_tpu`` (``src/repro/kernels/sil_mse/kernel.py:81``, its
``pallas_call`` at :108; the loss-only wrapper ``sil_mse_tpu`` is :122).  It
checks device, dtype, shapes and strides and raises on what the kernel does
not take, allocates the grad and the partial-sum buffer, launches on
PyTorch's current stream without synchronising, raises if the launch
reported a CUDA error, and adds one to ``dispatch.LAUNCHES["sil_mse"]``.

The labels are not checked against [0, M) here, since that would wait for
the card; the kernel guards the index itself and answers an out-of-range
label with a NaN loss and a NaN grad row.  The kernel is bound by bytes; the
source file says how its design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES

SOURCE = "sil_mse"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_BYTES = {torch.int32: 4, torch.int64: 8}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        lib.repro_sil_mse.argtypes = [_P, _L, _P, _L, _L, _P, _I, _P, _P, _P,
                                      _I, _I, _I, _I, _P]
        lib.repro_sil_mse.restype = _I
        lib.repro_sil_mse_blocks.argtypes = [_I]
        lib.repro_sil_mse_blocks.restype = _I
        lib._repro_typed = True
    return lib


def _checks(act, sil, labels):
    if act.device.type != "cuda":
        raise ValueError(f"sil_mse: act must be a CUDA tensor, got "
                         f"{act.device}")
    if sil.device != act.device or labels.device != act.device:
        raise ValueError(f"sil_mse: act, sil and labels must all be on "
                         f"{act.device}")
    if act.dtype not in _DTYPE_CODE:
        raise ValueError(f"sil_mse: act dtype {act.dtype} is not float32 or "
                         "bfloat16")
    if sil.dtype != torch.float32:
        raise ValueError(f"sil_mse: the SIL table must be float32, got "
                         f"{sil.dtype}")
    if labels.dtype not in _LABEL_BYTES:
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


def sil_mse_cuda(act: torch.Tensor, sil: torch.Tensor, labels: torch.Tensor):
    """act: (T, d) fp32/bf16, columns contiguous; sil: (d, M) fp32, any
    strides; labels: (T,) int32/int64.  Returns the fp32 scalar mean loss
    and dloss/dact (T, d) in act's dtype, in one pass."""
    _checks(act, sil, labels)
    t, d = act.shape
    lib = _lib()
    grad = torch.empty((t, d), dtype=act.dtype, device=act.device)
    partial = torch.empty((lib.repro_sil_mse_blocks(t),),
                          dtype=torch.float32, device=act.device)
    loss = torch.empty((), dtype=torch.float32, device=act.device)
    with torch.cuda.device(act.device):
        err = lib.repro_sil_mse(
            act.data_ptr(), act.stride(0), sil.data_ptr(), sil.stride(0),
            sil.stride(1), labels.data_ptr(), _LABEL_BYTES[labels.dtype],
            grad.data_ptr(), partial.data_ptr(), loss.data_ptr(),
            _DTYPE_CODE[act.dtype], t, d, sil.shape[1],
            torch.cuda.current_stream(act.device).cuda_stream)
    build.check(err, "sil_mse kernel")
    LAUNCHES.add("sil_mse")
    return loss, grad
