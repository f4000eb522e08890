"""Synthetic Intermediate Labels (paper §2, Eq. 1).

    SIL[i, j] ~ kappa * U(0, 1),   SIL in R^{N_P x M}

Column j is the synthetic target activation (width N_P = boundary features)
for every sample of class j.  For language models the "class" of a token
position is its next-token id, so M = vocab and the SIL is structurally a
random unembedding table; the table is keyed by label id, which makes it
order-free.

The tables come from an explicit ``torch.Generator``.  Torch cannot
reproduce the reference's threefry bits, so conformance tests carry the
reference's table across (``repro_torch.convert.sil_from_numpy``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_sil(gen: Optional[torch.Generator], n_features: int,
             n_classes: int, kappa: float, dtype=torch.float32,
             device=None, class_major: bool = False) -> torch.Tensor:
    """Eq. 1: (N_P, M) matrix with entries kappa * U(0,1), drawn on the
    generator's device and placed on ``device`` (default: the same).

    ``class_major``: the table is drawn into (M, N_P) storage and returned
    as its (N_P, M) view, so each class's column is contiguous: the layout
    the SIL-MSE kernel gathers with 16-byte loads (the LM table, 151,936
    classes of 1,536 features, 0.93 GB, is never copied transposed)."""
    gdev = gen.device if gen is not None else torch.device("cpu")
    shape = (n_classes, n_features) if class_major \
        else (n_features, n_classes)
    u = torch.rand(shape, generator=gen, device=gdev, dtype=torch.float32)
    u = u.mul_(kappa).to(dtype=dtype, device=device or gdev)
    return u.t() if class_major else u


def make_stage_sils(gen: Optional[torch.Generator], widths: Sequence[int],
                    n_classes: int, kappa: float, dtype=torch.float32,
                    device=None) -> list:
    """One SIL per interior cut, drawn in order from ``gen``.  widths[k] =
    boundary feature count of cut k (the output width of stage k)."""
    return [make_sil(gen, w, n_classes, kappa, dtype, device) for w in widths]


def sil_lookup(sil: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Synthetic target activations for ``labels`` (any int shape) ->
    (*, N_P): a gather of rows of the (M, N_P) transpose, which for a
    class-major table is its contiguous storage."""
    return sil.t()[labels.long()]
