"""BoundaryCache: storage for materialized partition-boundary activations
(counterpart of ``repro/train/boundary.py``).

The paper's Fig.-3 schedule communicates between partitions exactly once: the
trained prefix runs forward over the dataset and the boundary activations are
stored for the suffix to train on.  The cache reserves the destination
buffer once and writes device-sized chunks into it as they are pulled from
the card; when the buffer would exceed ``spill_threshold_bytes`` (or a
``spill_dir`` is forced) it is backed by an on-disk ``np.memmap`` so
production-sized materializations need not fit in host RAM.

``reserve(..., dtype)`` takes the torch dtype of the activations (the
precision policy's compute dtype), so a bf16 policy halves both the RAM
buffer and the spill.  numpy has no bfloat16 of its own, so 16-bit floats
are stored as their raw bits (``int16``); ``tensor()`` (every row, the
MLP's one upload) and ``rows()`` (one LM batch a step) give them back in
their dtype.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

_DEFAULT_SPILL_THRESHOLD = 8 << 30  # 8 GiB
# torch dtype -> (numpy storage dtype, torch view of those bits)
_STORAGE = {torch.float32: (np.float32, torch.float32),
            torch.bfloat16: (np.int16, torch.int16),
            torch.float16: (np.int16, torch.int16)}


class BoundaryCache:
    """Chunk-filled (N, *feat) activation store with optional disk spill."""

    def __init__(self, spill_dir: Optional[str] = None,
                 spill_threshold_bytes: int = _DEFAULT_SPILL_THRESHOLD):
        self.spill_dir = spill_dir
        self.spill_threshold_bytes = spill_threshold_bytes
        self._buf: Optional[np.ndarray] = None
        self._path: Optional[str] = None
        self._n_filled = 0
        self.dtype: Optional[torch.dtype] = None

    # -- lifecycle ---------------------------------------------------------

    def reserve(self, n_rows: int, feat_shape: Tuple[int, ...],
                dtype: torch.dtype) -> None:
        """Allocate the destination once (RAM or memmap)."""
        if self._buf is not None:
            raise RuntimeError("BoundaryCache already reserved")
        if dtype not in _STORAGE:
            raise ValueError(f"BoundaryCache: unsupported dtype {dtype}")
        self.dtype = dtype
        np_dtype = _STORAGE[dtype][0]
        shape = (n_rows,) + tuple(feat_shape)
        nbytes = int(np.prod(shape)) * np.dtype(np_dtype).itemsize
        if self.spill_dir is not None or nbytes > self.spill_threshold_bytes:
            d = self.spill_dir or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            fd, self._path = tempfile.mkstemp(suffix=".boundary.npy", dir=d)
            os.close(fd)
            self._buf = np.memmap(self._path, dtype=np_dtype, mode="w+",
                                  shape=shape)
        else:
            self._buf = np.empty(shape, dtype=np_dtype)
        self._n_filled = 0

    def append(self, chunk: torch.Tensor) -> None:
        """Write one device-sized chunk (the host copy happens here, once)."""
        if self._buf is None:
            raise RuntimeError("reserve() before append()")
        if chunk.dtype != self.dtype:
            raise ValueError(f"chunk dtype {chunk.dtype} != reserved "
                             f"{self.dtype}")
        host = chunk.detach().cpu().view(_STORAGE[self.dtype][1]).numpy()
        n = len(host)
        if self._n_filled + n > len(self._buf):
            raise ValueError(
                f"cache overflow: reserved {len(self._buf)} rows, "
                f"got {self._n_filled + n}")
        self._buf[self._n_filled:self._n_filled + n] = host
        self._n_filled += n

    # -- access ------------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self._n_filled

    @property
    def spilled(self) -> bool:
        return self._path is not None

    @property
    def nbytes(self) -> int:
        return 0 if self._buf is None else self._buf.nbytes

    def array(self) -> np.ndarray:
        """The filled prefix of the reserved buffer (zero-copy view; raw
        bits for 16-bit floats)."""
        if self._buf is None:
            raise RuntimeError("cache is empty")
        return self._buf[: self._n_filled]

    def tensor(self, device) -> torch.Tensor:
        """A copy of the filled rows as one tensor of the cached dtype on
        ``device`` (a single upload)."""
        host = torch.from_numpy(np.array(self.array()))
        return host.view(self.dtype).to(device)

    def rows(self, start: int, stop: int, device) -> torch.Tensor:
        """Rows ``[start, stop)`` as a tensor of the cached dtype on
        ``device``.  Only those rows are read (a spill pages in just them)
        and uploaded; a card gets them from pinned memory without waiting
        for the host (``to_device``)."""
        host = torch.from_numpy(self.array()[start:stop])
        return to_device(host, device).view(self.dtype)

    def close(self) -> None:
        self._buf = None
        if self._path is not None:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = None


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor's copy on ``device``: to a card through a pinned
    staging copy and a ``non_blocking`` upload (torch's pinned allocator
    keeps the staging block until the copy has run), on the CPU a plain
    copy."""
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()
