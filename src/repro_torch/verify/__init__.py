"""``repro_torch.verify`` — the port's declarative differential-oracle
conformance subsystem (counterpart of ``repro.verify``).

Every equivalence contract the port promises is a registered ``Oracle`` —
(reference path, optimized path, comparison policy) — runnable from
pytest, from the ``launch/verify`` CLI sweep, or programmatically:

    from repro_torch.verify import all_oracles, run_oracle, Context

    for oracle in all_oracles(tags=["serve"]):
        result = run_oracle(oracle, Context(preset="tiny",
                                            arch="qwen2-1.5b",
                                            device="cuda"))
        print(result.name, result.ok)

Modules:
* ``compare``    — the tolerance-policy tiers (Bitwise / dtype-aware
                   Allclose / AccuracyGap / TokensEqual).
* ``oracle``     — Oracle/Context/registry/run_oracle.
* ``scenarios``  — shared tiny-config worlds.
* ``oracles``    — the registered contracts (importing this package
                   populates the registry).
* ``paper``      — the end-to-end paper-parity gate (EMNIST 6-layer,
                   2-stage SIL vs conventional; tiny and full presets).
* ``report``     — machine-readable conformance reports.
"""
from repro_torch.verify.compare import (AccuracyGap, Allclose,  # noqa: F401
                                        Bitwise, TokensEqual, Verdict,
                                        tolerance_for)
from repro_torch.verify.oracle import (Context, Oracle,  # noqa: F401
                                       OracleResult, all_oracles, get,
                                       register, run_oracle)
from repro_torch.verify.report import build_report, write_report  # noqa: F401

# importing the contract definitions populates the registry
from repro_torch.verify import oracles as _oracles  # noqa: E402,F401

__all__ = [
    "AccuracyGap", "Allclose", "Bitwise", "TokensEqual", "Verdict",
    "tolerance_for", "Context", "Oracle", "OracleResult", "all_oracles",
    "get", "register", "run_oracle", "build_report", "write_report",
]
