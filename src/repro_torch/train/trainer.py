"""The phase-sequence Trainer (counterpart of ``repro/train/trainer.py``).

``Trainer(backend, spec).run(phases, params=...)`` executes a list of
``repro_torch.train.phases`` objects over shared mutable ``TrainState`` and
returns the joined parameters plus a unified ``History``:

    Fig. 3     [SilStagePhase(0), BoundaryMaterializePhase(1),
                FrozenPrefixPhase(1), RecoveryPhase(0)]
    baseline   [BaselinePhase()]

``drive_epochs`` keeps the reference's contract of no per-step host sync:
each epoch's step losses land in a device tensor and are read by the host
once per phase, when they go into the loss histogram and the History as
``loss`` records, ``step`` counting the phase's optimizer steps from 0 (the
reference's MLP epoch loop logs only the evaluations; its LM loop logs losses
the same way).  An evaluation record carries the step index of the last
step before it.
``drive_steps`` and ``flush_losses`` (LM stream phases) wait for the LM
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.obs.metrics import LOSS_BUCKETS
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TID_LOOP, Tracer
from repro_torch.optim import read_skipped
from repro_torch.train.backends import epoch_fn
from repro_torch.train.history import History


class SkippedStepBudgetExceeded(RuntimeError):
    """More optimizer steps were NaN/inf-skipped than
    ``TrainSpec.max_skipped_steps`` allows: the run is diverging, so it
    aborts loudly instead of burning compute on a params-frozen loop."""


@dataclass
class TrainState:
    stage_params: List[Any]
    sils: List[Any] = field(default_factory=list)
    history: History = field(default_factory=History)
    boundary: Dict[str, Any] = field(default_factory=dict)
    cum_macs: int = 0
    skipped_steps: int = 0     # NaN/inf-guarded steps skipped (all stages)


class Trainer:
    """Runs a phase sequence over the MLP backend."""

    def __init__(self, backend, spec, *,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        """metrics/tracer (optional): a ``MetricsRegistry`` for the
        trainer's series (a private one by default) and a ``Tracer`` for
        phase spans."""
        self.backend = backend
        self.spec = spec
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self._loss_hist = self.metrics.histogram(
            "train_loss", LOSS_BUCKETS, help="per-step training loss")
        self._skipped = self.metrics.counter(
            "train_skipped_steps_total",
            help="NaN/inf-guarded optimizer steps skipped, by phase[stage]")

    def run(self, phases: Sequence, *, params, sils: Optional[list] = None,
            gen: Optional[torch.Generator] = None):
        """Execute `phases` starting from full `params`.

        `sils`: per-cut SIL tables; drawn from `gen` by the backend when
        omitted and a phase needs them.  Returns (joined_params, History).
        """
        needs_sil = any(getattr(p, "needs_sil", False) for p in phases)
        if sils is None and needs_sil:
            if gen is None:
                raise ValueError("phases need SIL tables: pass sils= or gen=")
            sils = self.backend.make_sils(gen, self.spec.kappa)
        state = TrainState(stage_params=self.backend.split(params),
                           sils=sils or [])
        if getattr(self.backend, "dropped_per_epoch", 0):
            state.history.meta["dropped_per_epoch"] = \
                self.backend.dropped_per_epoch
            self.metrics.gauge(
                "train_dropped_per_epoch",
                help="samples tail-dropped per epoch by batching").set(
                    self.backend.dropped_per_epoch)
        try:
            for phase in phases:
                with self.tracer.span(type(phase).__name__, cat="phase",
                                      tid=TID_LOOP):
                    phase.run(self, state)
        finally:
            for cache in state.boundary.values():
                if hasattr(cache, "close"):
                    cache.close()
        self.metrics.drain()     # end-of-run flush boundary (idempotent)
        return self.backend.join(state.stage_params), state.history

    # ------------------------------------------------------------------
    # the epoch loop (used by the phases)
    # ------------------------------------------------------------------

    def drive_epochs(self, state: TrainState, *, step, train_params,
                     opt_state, epochs: int, phase_name: str, stage: int,
                     macs_per_sample: int, seed_base: int, log_mode: str,
                     eval_fn=None, batch_arrays=None):
        """MLP epoch loop: one device-side epoch of steps at a time.

        batch_arrays(ep) -> tuple of (nb, bs, ...) tensors; defaults to the
        backend dataset.  eval_fn(train_params) -> joined-network accuracy
        (the paper's y-axis); defaults to substituting the in-flight stage
        into the current stage list.  log_mode: 'cadence' | 'cadence+last'
        | 'every' (the reference's three evaluation cadences)."""
        be = self.backend
        if batch_arrays is None:
            def batch_arrays(ep):
                return be.epoch_arrays(seed_base + ep, be.spec.shuffle)
        if eval_fn is None:
            def eval_fn(tp):
                sp = list(state.stage_params)
                sp[stage] = tp
                return be.eval_joined(sp)
        run_epoch = epoch_fn(step)
        eval_every = be.spec.eval_every
        step_losses, n_steps = [], 0
        for ep in range(epochs):
            batches = batch_arrays(ep)
            train_params, opt_state, losses = run_epoch(train_params,
                                                        opt_state, batches)
            step_losses.append(losses)
            n_steps += batches[0].shape[0]
            n_samples = batches[0].shape[0] * batches[0].shape[1]
            state.cum_macs += macs_per_sample * n_samples
            if (log_mode == "every" or (ep + 1) % eval_every == 0
                    or (log_mode == "cadence+last" and ep == epochs - 1)):
                state.history.log(phase=phase_name, stage=stage,
                                  step=n_steps - 1, macs=state.cum_macs,
                                  acc=eval_fn(train_params))
        if step_losses:      # the phase's one read of its step losses
            for i, v in enumerate(torch.cat(step_losses).tolist()):
                self._loss_hist.observe(v)
                state.history.log(phase=phase_name, stage=stage, step=i,
                                  loss=v)
        self.note_skipped(state, opt_state, phase_name, stage)
        return train_params, opt_state

    def note_skipped(self, state: TrainState, opt_state, phase_name,
                     stage) -> None:
        """End-of-phase skipped-step telemetry: the one host read of the
        step guard's device counter, at phase granularity.  Raises
        ``SkippedStepBudgetExceeded`` past ``spec.max_skipped_steps``."""
        counter = read_skipped(opt_state)
        if counter is None:
            return
        skipped = int(counter.item())
        if not skipped:
            return
        per_phase = state.history.meta.setdefault("skipped_steps", {})
        key = f"{phase_name}[{stage}]"
        # counters are cumulative per opt_state; keep the high-water mark
        prev = per_phase.get(key, 0)
        if skipped > prev:
            self._skipped.inc(skipped - prev, phase=key)
        per_phase[key] = max(prev, skipped)
        state.skipped_steps = sum(per_phase.values())
        budget = getattr(self.spec, "max_skipped_steps", None)
        if budget is not None and state.skipped_steps > budget:
            raise SkippedStepBudgetExceeded(
                f"{state.skipped_steps} non-finite optimizer steps skipped "
                f"(> budget {budget}) by phase {phase_name!r} stage {stage}: "
                "the run is diverging -- lower the lr or raise "
                "TrainSpec.max_skipped_steps")
