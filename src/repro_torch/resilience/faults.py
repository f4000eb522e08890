"""Deterministic, seeded fault injection for the port's stage-training
stack (counterpart of ``repro/resilience/faults.py``; the fault types,
``FaultSchedule``, ``FakeClock`` and the corruption modes are the
reference's, value for value).

The paper's zero-communication property makes per-stage fault tolerance
*testable*: a stage failure touches exactly one stage's state, so an
injected fault plus a correct recovery must reproduce the fault-free run
bit-for-bit.  This module supplies the faults; ``resilience.supervisor``
supplies the recovery.

Design rules:

* **Typed faults, explicit seams.** Each fault targets one seam the real
  system has anyway — the executor's tick dispatch (``StageCrash``,
  ``TransientError``, ``StragglerDelay``), its batch input path
  (``NaNInjection``, via ``StageExecutor.batch_hook``), or the checkpoint
  files on disk (``CheckpointCorruption``).  Nothing patches a step
  function or a kernel: injected faults live at the same host-level
  boundaries real faults (OOM, preemption, torn write, bad batch) arrive
  at.
* **Replayable from a seed.** ``FaultSchedule.sample(seed, ...)`` draws a
  schedule with a dedicated ``random.Random`` stream; the same seed always
  yields the same faults at the same (stage, tick) coordinates as the
  reference's, so every chaos-CLI failure is reproducible by its seed
  alone.
* **Deterministic time.** ``FakeClock`` stands in for wall time in tests
  and the chaos CLI — backoff/straggler delays advance a counter instead
  of sleeping, keeping chaos runs fast and bit-stable.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FAULT_KINDS = ("crash", "transient", "ckpt_corruption", "nan", "straggler")


@dataclass(frozen=True)
class Fault:
    """Base: a typed fault aimed at one stage at one tick."""
    stage: int
    tick: int

    kind = "fault"

    def describe(self) -> str:
        return f"{self.kind}(stage={self.stage}, tick={self.tick})"


@dataclass(frozen=True)
class StageCrash(Fault):
    """The stage process dies: its live params/optimizer state are lost and
    must come back from the stage's own checkpoints."""
    kind = "crash"


@dataclass(frozen=True)
class TransientError(Fault):
    """A device error that clears on retry (an allocation that fails once
    under memory pressure, a network blip).  The stage's live state
    survives; the tick just has to be re-attempted.  ``failures`` is how
    many consecutive attempts fail before the error clears."""
    failures: int = 1
    kind = "transient"


@dataclass(frozen=True)
class CheckpointCorruption(Fault):
    """A torn/corrupted checkpoint file for this stage at (or nearest below)
    this tick — what a crash mid-``save_stage`` leaves behind without the
    atomic-write path, and what bit rot leaves behind with it.  ``mode``
    picks the damage: truncate the manifest, truncate the npz archive, or
    flip bytes inside the archive (checksum-detectable)."""
    mode: str = "truncate_manifest"   # | "truncate_npz" | "flip_bytes"
    kind = "ckpt_corruption"


@dataclass(frozen=True)
class NaNInjection(Fault):
    """Poison the stage's input batch at this tick with inf/NaN — a bad
    data shard or an upstream numeric blowup.  The NaN step guard must skip
    the poisoned optimizer step on-device."""
    value: float = float("inf")
    kind = "nan"


@dataclass(frozen=True)
class StragglerDelay(Fault):
    """The stage's device stalls for ``delay`` clock units at this tick.
    Zero inter-stage communication means the supervisor must keep every
    OTHER stage ticking at full speed while this one waits."""
    delay: float = 1.0
    kind = "straggler"


_KIND_TO_CLS = {"crash": StageCrash, "transient": TransientError,
                "ckpt_corruption": CheckpointCorruption, "nan": NaNInjection,
                "straggler": StragglerDelay}


@dataclass
class FaultSchedule:
    """An ordered, replayable set of faults keyed by (stage, tick).

    The schedule is data, not behavior: the supervisor consults it at each
    seam (``crash_at``, ``transient_at``, ...) and marks faults consumed so
    a replayed tick — the whole point of recovery — does not re-fire the
    fault that killed it the first time."""
    faults: List[Fault] = field(default_factory=list)
    seed: Optional[int] = None

    def __post_init__(self):
        self._consumed: set = set()
        self._transient_left: Dict[Tuple[int, int], int] = {
            (f.stage, f.tick): f.failures for f in self.faults
            if isinstance(f, TransientError)}

    # -- construction ------------------------------------------------------

    @classmethod
    def sample(cls, seed: int, *, n_stages: int, n_ticks: int,
               n_faults: int = 3,
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultSchedule":
        """Draw a random schedule — same seed, same faults, forever.

        Faults land on distinct (stage, tick) coordinates with tick >= 1
        (tick 0 must complete once so every stage has a recovery point
        beyond its init checkpoint)."""
        rng = random.Random(seed)
        unknown = [k for k in kinds if k not in _KIND_TO_CLS]
        if unknown:
            raise ValueError(f"unknown fault kinds {unknown}; "
                             f"choose from {sorted(_KIND_TO_CLS)}")
        coords = [(s, t) for s in range(n_stages) for t in range(1, n_ticks)]
        rng.shuffle(coords)
        faults: List[Fault] = []
        for stage, tick in coords[:n_faults]:
            kind = rng.choice(list(kinds))
            if kind == "crash":
                faults.append(StageCrash(stage, tick))
            elif kind == "transient":
                faults.append(TransientError(stage, tick,
                                             failures=rng.randint(1, 2)))
            elif kind == "ckpt_corruption":
                mode = rng.choice(("truncate_manifest", "truncate_npz",
                                   "flip_bytes"))
                faults.append(CheckpointCorruption(stage, tick, mode=mode))
            elif kind == "nan":
                value = rng.choice((float("inf"), float("nan")))
                faults.append(NaNInjection(stage, tick, value=value))
            else:
                faults.append(StragglerDelay(stage, tick,
                                             delay=rng.uniform(0.5, 2.0)))
        faults.sort(key=lambda f: (f.tick, f.stage))
        return cls(faults=faults, seed=seed)

    # -- seam queries ------------------------------------------------------

    def _find(self, cls, stage: int, tick: int) -> Optional[Fault]:
        for f in self.faults:
            if (isinstance(f, cls) and f.stage == stage and f.tick == tick
                    and id(f) not in self._consumed):
                return f
        return None

    def consume(self, fault: Fault) -> None:
        self._consumed.add(id(fault))

    def crash_at(self, stage: int, tick: int) -> Optional[StageCrash]:
        return self._find(StageCrash, stage, tick)

    def straggler_at(self, stage: int, tick: int) -> Optional[StragglerDelay]:
        return self._find(StragglerDelay, stage, tick)

    def corruption_at(self, stage: int,
                      tick: int) -> Optional[CheckpointCorruption]:
        return self._find(CheckpointCorruption, stage, tick)

    def transient_failing(self, stage: int, tick: int) -> bool:
        """True while the transient fault at (stage, tick) still has
        failures left; each call consumes one failure."""
        f = self._find(TransientError, stage, tick)
        if f is None:
            return False
        left = self._transient_left.get((stage, tick), 0)
        if left <= 0:
            self.consume(f)
            return False
        self._transient_left[(stage, tick)] = left - 1
        if left - 1 <= 0:
            self.consume(f)
        return True

    def nan_batch_hook(self):
        """``StageExecutor.batch_hook`` implementing every ``NaNInjection``
        in this schedule: poisons element 0 of the first float array of the
        target stage's batch at the target tick.  Consumption is not needed
        — the poisoned step is *skipped* by the guard, so its replay (there
        is none: skipping IS the handling) never re-runs."""
        injections = {(f.stage, f.tick): f for f in self.faults
                      if isinstance(f, NaNInjection)}
        if not injections:
            return None

        def hook(stage: int, tick: int, batch):
            f = injections.get((stage, tick))
            if f is None:
                return batch
            return poison_batch(batch, f.value)

        return hook

    def unconsumed(self) -> List[Fault]:
        return [f for f in self.faults if id(f) not in self._consumed
                and not isinstance(f, NaNInjection)]

    def describe(self) -> List[str]:
        return [f.describe() for f in self.faults]


def _is_float(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _poisoned(a, value: float):
    """A copy of ``a`` with ``value`` in its first element (index 0 on
    every axis): a tensor is cloned on its own device in its own dtype, a
    numpy array copied on the host; the caller's array is never written."""
    if isinstance(a, torch.Tensor):
        out = a.clone()
        out[(0,) * out.dim()] = value
        return out
    out = np.array(a)
    out.reshape(-1)[0] = value
    return out


def poison_batch(batch, value: float = float("inf")):
    """Copy of ``batch`` with ``value`` written into element 0 of the first
    floating-point array found (tuple of tensors for the MLP backend, dict
    for the LM backend; torch tensors or numpy arrays).  Integer-only
    batches (token ids) raise — poison the float mask/loss channel for
    those."""
    if isinstance(batch, dict):
        for key in sorted(batch):
            if _is_float(batch[key]):
                out = dict(batch)
                out[key] = _poisoned(batch[key], value)
                return out
        raise ValueError("no floating-point array in dict batch to poison "
                         f"(keys={sorted(batch)})")
    seq = list(batch)
    for j, a in enumerate(seq):
        if _is_float(a):
            seq[j] = _poisoned(a, value)
            return tuple(seq)
    raise ValueError("no floating-point array in batch tuple to poison")


def apply_corruption(ckpt_root: str, stage: int,
                     mode: str = "truncate_manifest") -> Optional[str]:
    """Damage the NEWEST checkpoint of ``stage`` under ``ckpt_root`` (the
    port's files, ``<root>/stage_NN/ckpt_{step:08d}.{npz,json}``, named as
    the reference names them) the way ``mode`` says; returns the damaged
    path (None when the stage has no checkpoint yet).  Deterministic: the
    same mode on the same file always produces the same bytes, the
    reference's."""
    import os

    from repro_torch.checkpoint import available_steps
    from repro_torch.dist.lifecycle import stage_dir

    d = stage_dir(ckpt_root, stage)
    steps = available_steps(d)
    if not steps:
        return None
    step = steps[-1]
    npz = os.path.join(d, f"ckpt_{step:08d}.npz")
    manifest = os.path.join(d, f"ckpt_{step:08d}.json")
    if mode == "truncate_manifest":
        data = open(manifest, "rb").read()
        with open(manifest, "wb") as f:
            f.write(data[: len(data) // 2])
        return manifest
    if mode == "truncate_npz":
        data = open(npz, "rb").read()
        with open(npz, "wb") as f:
            f.write(data[: len(data) // 2])
        return npz
    if mode == "flip_bytes":
        data = bytearray(open(npz, "rb").read())
        # flip a byte in the back half — payload bytes, so either the zip
        # CRC or the manifest leaf checksum must catch it
        pos = len(data) // 2 + len(data) // 4
        data[pos] ^= 0xFF
        with open(npz, "wb") as f:
            f.write(bytes(data))
        return npz
    raise ValueError(f"unknown corruption mode {mode!r}")


class FakeClock:
    """Deterministic stand-in for (time.monotonic, time.sleep).

    ``sleep`` advances the clock instead of blocking, so backoff and
    straggler delays cost zero wall time in tests and chaos runs while
    still exercising the deadline arithmetic."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)
        self.sleeps: List[float] = []

    def monotonic(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        dt = max(0.0, float(dt))
        self.sleeps.append(dt)
        self.t += dt

    def advance(self, dt: float) -> None:
        self.t += float(dt)
