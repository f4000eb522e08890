"""Machine-readable conformance reports (counterpart of
``repro/verify/report.py``, the same schema and keys).

One report = one sweep of the oracle registry under one (preset, arch)
context: environment stamp, per-oracle verdicts with measured errors and
wall-clock, and the pass/fail tallies CI gates on.  ``env`` stamps torch's
version, the CUDA device's name (None without a card) and the device
count; the port has no ``REPRO_FORCE_REF`` (a tensor's device alone picks
the kernel or the plain path), so that key is left out.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import torch

from repro_torch.verify.oracle import OracleResult

SCHEMA = "repro.verify/1"


def env() -> dict:
    """torch's version, the CUDA device's name and the CUDA device count."""
    card = torch.cuda.is_available()
    return {"torch": torch.__version__,
            "device": torch.cuda.get_device_name(0) if card else None,
            "n_devices": torch.cuda.device_count() if card else 0}


def build_report(results: Sequence[OracleResult], *, preset: str,
                 arch: str, extra: Optional[dict] = None) -> dict:
    failed = [r.name for r in results if not r.ok]
    report = {
        "schema": SCHEMA,
        "preset": preset,
        "arch": arch,
        "env": env(),
        "n_oracles": len(results),
        "n_passed": sum(r.ok for r in results),
        "n_failed": len(failed),
        "failed": failed,
        "oracles": [r.row() for r in results],
    }
    if extra:
        report.update(extra)
    return report


def write_report(path: str, results: Sequence[OracleResult], *, preset: str,
                 arch: str, extra: Optional[dict] = None) -> dict:
    report = build_report(results, preset=preset, arch=arch, extra=extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return report
