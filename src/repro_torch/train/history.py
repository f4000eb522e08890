"""Unified training history for the phase API (a copy of
``repro/train/history.py``).

Every phase appends ``Record``s; the two legacy dict-of-lists formats (the
MLP trainers' ``{"macs", "acc", "phase"}`` and the LM trainers'
``{"stage", "step", "loss"}``) are derived views, kept so pre-redesign
consumers and tests keep working.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass
class Record:
    phase: str                 # "left" / "right" / "baseline" / "recovery" / ...
    stage: int                 # partition index; -1 for recovery / whole-net
    step: int                  # global optimizer-step index at log time
    macs: Optional[int] = None     # cumulative per-sample MACs (MLP backend)
    loss: Optional[float] = None
    acc: Optional[float] = None


class History:
    def __init__(self):
        self.records: List[Record] = []
        self.meta: Dict[str, Any] = {}

    def log(self, **kw) -> None:
        self.records.append(Record(**kw))

    def column(self, name: str, *, phase: Optional[str] = None,
               stage: Optional[int] = None) -> List[Any]:
        out = []
        for r in self.records:
            if phase is not None and r.phase != phase:
                continue
            if stage is not None and r.stage != stage:
                continue
            v = getattr(r, name)
            if v is not None:
                out.append(v)
        return out

    # -- legacy views ------------------------------------------------------

    def to_mlp_legacy(self) -> Dict[str, list]:
        """{"macs", "acc", "phase"} rows = eval points (acc is not None)."""
        hist = {"macs": [], "acc": [], "phase": []}
        for r in self.records:
            if r.acc is None:
                continue
            hist["macs"].append(r.macs)
            hist["acc"].append(r.acc)
            hist["phase"].append(r.phase)
        hist.update({k: v for k, v in self.meta.items()})
        return hist

    def to_lm_legacy(self) -> Dict[str, list]:
        """{"stage", "step", "loss"} rows = per-step losses."""
        hist = {"stage": [], "step": [], "loss": []}
        for r in self.records:
            if r.loss is None:
                continue
            hist["stage"].append(r.stage)
            hist["step"].append(r.step)
            hist["loss"].append(r.loss)
        hist.update({k: v for k, v in self.meta.items()})
        return hist
