"""The oracle registry: every equivalence contract as a named, runnable pair
(counterpart of ``repro/verify/oracle.py``; the port keeps a registry of
its own).

An ``Oracle`` is a declarative record of one equivalence the system promises:
a *reference path* (the trusted, simple implementation) against an
*optimized path* (kernel, placement, batching, precision, resume...), plus
the ``repro_torch.verify.compare`` policy that judges them.  Registration
makes a contract executable from three surfaces at once:

* ``tests/test_torch_oracles.py`` parametrizes the registered oracles into
  pytest;
* ``python -m repro_torch.launch.verify`` sweeps the registry from the CLI
  and writes a machine-readable conformance report;
* ``run_oracle`` is callable from anywhere (``chip_smoke.py``, notebooks).

An oracle's ``run(ctx)`` returns ``(reference, optimized)`` trees; the
policy turns them into a ``Verdict``.  ``Context.preset`` selects problem
size ("tiny" for the CPU, "full" for paper fidelity); ``Context.arch``
parameterizes LM-backed oracles over any ``repro_torch.configs`` entry;
``Context.device`` is where both paths run: ``"cuda"`` by default (raising
where torch sees no card, ``kernels.dispatch.resolve_device``), ``"cpu"``
for the plain PyTorch paths.
"""
from __future__ import annotations

import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.verify.compare import Verdict

PRESETS = ("tiny", "full")


@dataclass
class Context:
    """Execution context handed to every oracle run."""
    preset: str = "tiny"
    arch: str = "qwen2-1.5b"          # repro_torch.configs entry (LM oracles)
    workdir: Optional[str] = None     # scratch dir (checkpoint oracles)
    device: Any = "cuda"              # where both paths run

    def __post_init__(self):
        if self.preset not in PRESETS:
            raise ValueError(f"unknown preset {self.preset!r}; "
                             f"choose from {PRESETS}")
        self.device = resolve_device(self.device)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


@dataclass(frozen=True)
class Oracle:
    """One registered equivalence contract."""
    name: str                          # "group/contract", unique
    contract: str                      # one-line statement of the promise
    run: Callable[[Context], Tuple[Any, Any]]   # -> (reference, optimized)
    # a compare policy instance, or a Callable[[Context], policy] when the
    # strictness depends on the preset (e.g. paper budgets)
    policy: Any = None
    tags: Tuple[str, ...] = ()
    arch_aware: bool = False           # honors Context.arch

    def resolve_policy(self, ctx: Context):
        return self.policy(ctx) if callable(self.policy) else self.policy


@dataclass(frozen=True)
class OracleResult:
    name: str
    ok: bool
    seconds: float
    verdict: Optional[Verdict] = None
    error: Optional[str] = None

    def row(self) -> Dict[str, Any]:
        """Flat dict for the conformance report."""
        out = {"name": self.name, "ok": self.ok,
               "seconds": round(self.seconds, 3)}
        if self.verdict is not None:
            out["policy"] = self.verdict.policy
            out["detail"] = self.verdict.detail
            out["metrics"] = self.verdict.metrics
        if self.error is not None:
            out["error"] = self.error
        return out


_REGISTRY: Dict[str, Oracle] = {}


def register(name: str, contract: str, policy, *, tags: Sequence[str] = (),
             arch_aware: bool = False):
    """Decorator: register ``fn(ctx) -> (reference, optimized)`` as an
    oracle.  Double registration under one name is a bug, not an update."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"oracle {name!r} already registered")
        _REGISTRY[name] = Oracle(name=name, contract=contract, run=fn,
                                 policy=policy, tags=tuple(tags),
                                 arch_aware=arch_aware)
        return fn
    return deco


def get(name: str) -> Oracle:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no oracle {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def all_oracles(tags: Optional[Sequence[str]] = None) -> List[Oracle]:
    """Registered oracles, name-sorted; ``tags`` filters to any match."""
    out = sorted(_REGISTRY.values(), key=lambda o: o.name)
    if tags:
        want = set(tags)
        out = [o for o in out if want & set(o.tags)]
    return out


def run_oracle(oracle: Oracle, ctx: Optional[Context] = None) -> OracleResult:
    """Execute one oracle under ``ctx`` and judge it with its policy.

    Exceptions are captured into a failed result (the conformance sweep must
    report every contract, not die on the first broken one)."""
    ctx = ctx or Context()
    t0 = time.perf_counter()
    tmp = None
    try:
        if ctx.workdir is None:
            tmp = tempfile.TemporaryDirectory(prefix="repro_verify_")
            ctx = Context(preset=ctx.preset, arch=ctx.arch,
                          workdir=tmp.name, device=ctx.device)
        ref, opt = oracle.run(ctx)
        verdict = oracle.resolve_policy(ctx).compare(ref, opt)
        return OracleResult(oracle.name, verdict.ok,
                            time.perf_counter() - t0, verdict=verdict)
    except Exception:
        return OracleResult(oracle.name, False, time.perf_counter() - t0,
                            error=traceback.format_exc(limit=8))
    finally:
        if tmp is not None:
            tmp.cleanup()
