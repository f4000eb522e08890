"""Stage-aware training configuration for the phase API (a copy of
``repro/train/spec.py`` without its conversions from the legacy configs).

One ``TrainSpec`` carries per-stage optimizer / learning rate / duration
plus the SIL and batching knobs shared by every phase.

Durations are expressed in whichever unit the backend natively consumes —
**epochs** for the dataset-backed MLP backend, **steps** for the stream-backed
LM backend; a ``StageSpec`` may set either (or both, when the same spec is
reused across backends).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class StageSpec:
    """Hyperparameters of one partition stage (paper §2.1: per-partition
    hyperparameters are a core advantage of the scheme)."""
    epochs: int = 0            # MLP backend duration
    steps: int = 0             # LM backend duration
    lr: float = 1e-2
    optimizer: str = "sgdm"
    momentum: float = 0.9      # sgdm only
    # gradient-accumulation microbatches per optimizer step: the batch is
    # split `accum` ways inside the step and gradients accumulate in
    # the policy's accum dtype (fp32) — large effective batches under the
    # reduced-precision activation memory budget
    accum: int = 1
    # per-stage precision override — a precision preset name
    # ("fp32" | "bf16" | "fp16") or a PrecisionPolicy — for the OPTIMIZER
    # side only: loss scaling / master weights via make_optimizer_for (e.g.
    # fp16-scale one fragile stage).  The forward compute dtype is a
    # backend-wide choice taken from TrainSpec.precision (one backend runs
    # one model dtype); None inherits that spec-wide policy
    precision: Optional[object] = None
    # NaN/inf step guard override for this stage: None
    # inherits TrainSpec.nan_guard.  Irrelevant for stages whose precision
    # policy already wraps the optimizer in loss scaling (fp16) — that
    # wrapper skips-and-counts non-finite steps on its own
    nan_guard: Optional[bool] = None


@dataclass(frozen=True)
class TrainSpec:
    """One stage-aware config for every PNN training schedule.

    ``stages[k]`` configures partition k.  ``recovery_*`` configures the §5
    recovery phase (stage 0 fine-tuned end-to-end, the rest frozen).
    ``baseline`` (a StageSpec) configures conventional end-to-end training.
    """
    n_stages: int = 2
    kappa: float = 10.0
    stages: Tuple[StageSpec, ...] = ()
    baseline: Optional[StageSpec] = None
    recovery: Optional[StageSpec] = None
    # data / batching (MLP backend; the LM backend receives batches from a
    # caller-supplied batch_fn and ignores these)
    batch_size: int = 1410
    shuffle: bool = False
    eval_every: int = 1
    # spec-wide precision policy (preset name or PrecisionPolicy); None keeps
    # the legacy behavior: MLP backend fp32, LM backend the config's dtype
    precision: Optional[object] = None
    # ---- resilience -------------------------------------------------------
    # wrap every stage optimizer in optim.step_guard: a step whose grads
    # contain inf/nan is skipped in-device (params + optimizer state kept,
    # counter bumped) instead of silently poisoning the run.  fp16 stages
    # keep their mixed_precision skip — the guard never stacks on top of it
    nan_guard: bool = False
    # abort the run (SkippedStepBudgetExceeded) once the total number of
    # guard-skipped steps across a phase exceeds this; None = never abort
    max_skipped_steps: Optional[int] = None

    def stage(self, k: int) -> StageSpec:
        if self.stages and k < len(self.stages):
            return self.stages[k]
        return StageSpec()

    def with_stages(self, *stages: StageSpec) -> "TrainSpec":
        return replace(self, stages=tuple(stages), n_stages=len(stages))
