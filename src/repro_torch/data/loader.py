"""Batched loading with optional shuffling, onto a torch device (counterpart
of ``repro/data/loader.py``; ``device=`` takes the place of its
``sharding=``).

The paper trains the left partition *without shuffling* so SIL targets stay
aligned with sample order; we instead key SIL by label id (order-free), but
``shuffle=False`` reproduces the paper's exact regime.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class Batches:
    """Epoch iterator over aligned arrays.

    Per-epoch shuffle streams are drawn from a ``np.random.SeedSequence``
    spawned per (seed, epoch), so distinct (seed, epoch) pairs never collide
    (the old ``RandomState(seed + epoch)`` scheme made ``seed=0, epoch=1``
    and ``seed=1, epoch=0`` identical).  ``legacy_seeding=True`` pins the old
    behavior for bit-exact reproduction of pre-existing runs.  The order is
    the reference's, bit for bit.  With ``device`` each batch is a tuple of
    tensors on that device, else of numpy arrays.
    """

    def __init__(self, arrays, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, device=None,
                 legacy_seeding: bool = False):
        self.arrays = [np.asarray(a) for a in arrays]
        self.n = len(self.arrays[0])
        if any(len(a) != self.n for a in self.arrays):
            raise ValueError("Batches: arrays differ in length")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = None if device is None else torch.device(device)
        self.legacy_seeding = legacy_seeding

    def __len__(self):
        return self.n // self.batch_size if self.drop_last else \
            -(-self.n // self.batch_size)

    def order(self, epoch_idx: int = 0) -> np.ndarray:
        """The sample order of one epoch."""
        order = np.arange(self.n)
        if self.shuffle:
            if self.legacy_seeding:
                np.random.RandomState(self.seed + epoch_idx).shuffle(order)
            else:
                seq = np.random.SeedSequence(self.seed,
                                             spawn_key=(epoch_idx,))
                np.random.default_rng(seq).shuffle(order)
        return order

    def epoch(self, epoch_idx: int = 0) -> Iterator:
        order = self.order(epoch_idx)
        stop = self.n - (self.n % self.batch_size) if self.drop_last else self.n
        for i in range(0, stop, self.batch_size):
            idx = order[i:i + self.batch_size]
            out = [a[idx] for a in self.arrays]
            if self.device is not None:
                out = [torch.from_numpy(a).to(self.device) for a in out]
            yield tuple(out)
