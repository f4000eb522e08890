"""Image-classification data pipeline (a copy of ``repro/data/images.py``:
numpy only, so its arrays are bit-identical to the reference's).

The paper uses EMNIST-balanced (47 classes, 28x28).  EMNIST is not shipped with
the repository, so the default pipeline is a *deterministic synthetic
EMNIST-like* task: each class has a smooth random prototype image and samples
are prototype + structured noise, giving a task with the same input/label
geometry and a learnable but non-trivial decision boundary.  If a real
``emnist.npz`` exists (keys: train_x, train_y, test_x, test_y) it is used
instead.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

N_CLASSES = 47
IMG_DIM = 784


def _smooth(rng, n, size=28, blur=3):
    """Random smooth 2D patterns (box-blurred noise)."""
    img = rng.standard_normal((n, size + 2 * blur, size + 2 * blur))
    out = np.zeros((n, size, size))
    for dx in range(2 * blur + 1):
        for dy in range(2 * blur + 1):
            out += img[:, dx:dx + size, dy:dy + size]
    out /= (2 * blur + 1) ** 2
    return out


def emnist_like(n_train: int = 112800, n_test: int = 18800, seed: int = 0,
                noise: float = 0.9) -> Tuple[np.ndarray, ...]:
    """Deterministic EMNIST-like dataset.

    Returns (train_x (N,784) float32 in [0,1]-ish, train_y, test_x, test_y).
    Sized like EMNIST-balanced by default (112800 train / 18800 test).
    """
    rng = np.random.RandomState(seed)
    protos = _smooth(rng, N_CLASSES)                      # (47, 28, 28)
    protos = (protos - protos.min(axis=(1, 2), keepdims=True))
    protos /= np.maximum(protos.max(axis=(1, 2), keepdims=True), 1e-6)

    def make(n, seed_off):
        r = np.random.RandomState(seed + 1 + seed_off)
        y = r.randint(0, N_CLASSES, size=n)
        base = protos[y]
        # structured noise: per-sample smooth deformation + pixel noise
        pix = r.standard_normal(base.shape) * noise * 0.25
        gain = 1.0 + 0.2 * r.standard_normal((n, 1, 1))
        x = np.clip(base * gain + pix, 0.0, 1.5)
        return x.reshape(n, IMG_DIM).astype(np.float32), y.astype(np.int32)

    tx, ty = make(n_train, 0)
    vx, vy = make(n_test, 1)
    return tx, ty, vx, vy


def load_emnist(path: str = "data/emnist.npz", **kw):
    """Real EMNIST if available, synthetic otherwise."""
    if os.path.exists(path):
        z = np.load(path)
        return (z["train_x"].reshape(-1, IMG_DIM).astype(np.float32) / 255.0,
                z["train_y"].astype(np.int32),
                z["test_x"].reshape(-1, IMG_DIM).astype(np.float32) / 255.0,
                z["test_y"].astype(np.int32))
    return emnist_like(**kw)
