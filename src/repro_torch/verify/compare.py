"""Comparison policies for the conformance checks (a copy of
``repro/verify/compare.py`` whose leaves are torch tensors, numpy arrays or
python numbers).

Each strictness tier the port's checks use is a small policy object with
``compare(ref, opt) -> Verdict`` (the reference's ``Bitwise`` and
``TokensEqual`` tiers have no caller in the port yet):

* ``Allclose``     — dtype-aware float tolerance.  Tolerances default from
                     the WIDEST (least precise) dtype seen on either side,
                     so a bf16 check is automatically judged at bf16
                     tolerance while its fp32 twin stays tight.  Used for
                     kernel-vs-reference and cross-device equivalences
                     (different reduction orders, same math).
* ``AccuracyGap``  — the paper's own criterion: an end-metric (test
                     accuracy) may differ by at most ``budget`` absolute.
                     Used where the two paths are *different training
                     procedures* that the paper claims are equivalent in
                     outcome, not in bits.

``ref`` / ``opt`` may be nested dicts/lists; leaves are compared pairwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class Verdict:
    """Outcome of one comparison: pass/fail plus the measured error."""
    ok: bool
    policy: str
    detail: str = ""
    metrics: Dict[str, Any] = field(default_factory=dict)


# dtype -> (rtol, atol); keyed by string so ml_dtypes never needs importing.
# The table answers "how close must two runs of the same math in this dtype
# be" — fp32 tolerances match the repo's long-standing kernel/dist tests.
DTYPE_TOLERANCES: Dict[str, Tuple[float, float]] = {
    "float64": (1e-12, 1e-12),
    "float32": (1e-5, 1e-6),
    "float16": (1e-2, 1e-3),
    "bfloat16": (2e-2, 2e-2),
}
_WIDE_ORDER = ["float64", "float32", "float16", "bfloat16"]


def _dtype_name(d) -> str:
    if isinstance(d, str):
        return d
    if isinstance(d, torch.dtype):
        return str(d).replace("torch.", "")
    return str(np.dtype(d))


def _leaf(x) -> Tuple[np.ndarray, str]:
    """(values, dtype name).  numpy has no bfloat16, so 16-bit float tensors
    are compared in float32 (exact) under their own dtype's name."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        name = _dtype_name(x.dtype)
        if x.dtype in (torch.bfloat16, torch.float16):
            return x.float().numpy(), name
        return x.numpy(), name
    a = np.asarray(x)
    return a, _dtype_name(a.dtype)


def _leaves(tree):
    return [_leaf(x) for x in tree_leaves(tree)]


def tolerance_for(*dtypes) -> Tuple[float, float]:
    """(rtol, atol) for the least precise dtype among ``dtypes`` (names,
    numpy or torch dtypes)."""
    worst = "float64"
    for d in dtypes:
        s = _dtype_name(d)
        if s in _WIDE_ORDER and _WIDE_ORDER.index(s) > _WIDE_ORDER.index(worst):
            worst = s
    return DTYPE_TOLERANCES[worst]


@dataclass(frozen=True)
class Allclose:
    """Dtype-aware float closeness; non-float leaves must match exactly.

    Explicit ``rtol``/``atol`` override the dtype table (for contracts whose
    error model is looser than one ulp-scale, e.g. long reductions)."""
    rtol: Optional[float] = None
    atol: Optional[float] = None
    kind = "allclose"

    def compare(self, ref, opt) -> Verdict:
        la, lb = _leaves(ref), _leaves(opt)
        if len(la) != len(lb):
            return Verdict(False, self.kind,
                           f"leaf count differs: {len(la)} vs {len(lb)}")
        max_abs = 0.0
        for i, ((a, da), (b, db)) in enumerate(zip(la, lb)):
            if a.shape != b.shape:
                return Verdict(False, self.kind,
                               f"leaf {i} shape {a.shape} vs {b.shape}")
            if not np.issubdtype(a.dtype, np.floating):
                if not np.array_equal(a, b):
                    return Verdict(False, self.kind,
                                   f"non-float leaf {i} differs")
                continue
            rtol, atol = tolerance_for(da, db)
            rtol = self.rtol if self.rtol is not None else rtol
            atol = self.atol if self.atol is not None else atol
            af, bf = a.astype(np.float64), np.asarray(b).astype(np.float64)
            err = float(np.max(np.abs(af - bf))) if af.size else 0.0
            max_abs = max(max_abs, err)
            if not np.allclose(af, bf, rtol=rtol, atol=atol, equal_nan=True):
                return Verdict(
                    False, self.kind,
                    f"leaf {i} exceeds tolerance (max|err|={err:.3e}, "
                    f"rtol={rtol}, atol={atol})",
                    {"leaf": i, "max_abs_err": err, "rtol": rtol,
                     "atol": atol})
        return Verdict(True, self.kind, metrics={"max_abs_err": max_abs,
                                                 "n_leaves": len(la)})


@dataclass(frozen=True)
class AccuracyGap:
    """|ref_metric - opt_metric| <= budget (both scalars, e.g. accuracy).

    ``floor`` additionally requires the reference itself to have learned —
    a gap of 0 between two models at chance is not a reproduction."""
    budget: float = 0.02
    floor: float = 0.0
    kind = "accuracy_gap"

    def compare(self, ref, opt) -> Verdict:
        r, o = float(ref), float(opt)
        gap = abs(r - o)
        metrics = {"ref": r, "opt": o, "gap": gap, "budget": self.budget}
        if r < self.floor:
            return Verdict(False, self.kind,
                           f"reference metric {r:.4f} below floor "
                           f"{self.floor:.4f} (did not learn)", metrics)
        if gap > self.budget:
            return Verdict(False, self.kind,
                           f"gap {gap:.4f} exceeds budget {self.budget:.4f} "
                           f"(ref={r:.4f}, opt={o:.4f})", metrics)
        return Verdict(True, self.kind, metrics=metrics)

