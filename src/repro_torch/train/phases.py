"""Composable training phases (the paper's schedule, decomposed), counterpart
of the MLP branches of ``repro/train/phases.py``.

Each phase is a small dataclass with ``run(trainer, state)``; a training
procedure is a *list* of phases executed in order over a shared
``TrainState``:

* ``BaselinePhase``            -- conventional end-to-end training.
* ``SilStagePhase``            -- train stage 0 against its SIL targets
                                  (paper Fig. 3 "left" phase).
* ``BoundaryMaterializePhase`` -- run the frozen prefix over the data once
                                  and store the boundary (the paper's only
                                  communication) in a ``BoundaryCache``.
* ``FrozenPrefixPhase``        -- train a stage on the stored boundary with
                                  its natural loss (CE for the last stage;
                                  Fig. 3 "right" phase).
* ``RecoveryPhase``            -- §5: fine-tune one stage end-to-end with
                                  the others frozen.
* ``ParallelSilPhase``         -- Fig. 5; not ported yet (raises).

Per-phase ``lr`` / ``optimizer`` / duration default to the ``TrainSpec``'s
per-stage entries; ``seed_base`` sets the epoch shuffles as the
reference's.  The transformer branches, ``plan=`` placement and
``source="live"`` wait for later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.train.backends import make_optimizer_for
from repro_torch.train.boundary import BoundaryCache
from repro_torch.train.spec import StageSpec


def _mlp_only(be, what: str) -> None:
    if be.kind != "mlp":
        raise NotImplementedError(f"{what} on the {be.kind} backend is not "
                                  "ported yet (LM slice)")


def _no_plan(plan, what: str) -> None:
    if plan is not None:
        raise NotImplementedError(f"{what}(plan=...) device placement is "
                                  "not ported yet")


@dataclass
class PhaseBase:
    # overrides; default to the TrainSpec's per-stage entries
    epochs: Optional[int] = None
    steps: Optional[int] = None
    lr: Optional[float] = None
    optimizer: Optional[str] = None
    momentum: Optional[float] = None
    accum: Optional[int] = None
    precision: Optional[object] = None
    nan_guard: Optional[bool] = None
    seed_base: int = 0
    needs_sil = False

    def resolve(self, base: StageSpec) -> StageSpec:
        return StageSpec(
            epochs=self.epochs if self.epochs is not None else base.epochs,
            steps=self.steps if self.steps is not None else base.steps,
            lr=self.lr if self.lr is not None else base.lr,
            optimizer=self.optimizer or base.optimizer,
            momentum=self.momentum if self.momentum is not None
            else base.momentum,
            accum=self.accum if self.accum is not None else base.accum,
            precision=self.precision if self.precision is not None
            else base.precision,
            nan_guard=self.nan_guard if self.nan_guard is not None
            else base.nan_guard)


# ==========================================================================

@dataclass
class BaselinePhase(PhaseBase):
    """Conventional training of the unpartitioned network."""
    name: str = "baseline"

    def run(self, trainer, state) -> None:
        be = trainer.backend
        _mlp_only(be, "BaselinePhase")
        hp = self.resolve(trainer.spec.baseline or trainer.spec.stage(0))
        opt = make_optimizer_for(hp, trainer.spec)
        params = be.join(state.stage_params)
        params, _ = trainer.drive_epochs(
            state, step=be.build_baseline_step(opt, accum=hp.accum),
            train_params=params, opt_state=opt.init(params),
            epochs=hp.epochs, phase_name=self.name, stage=-1,
            macs_per_sample=be.full_macs(), seed_base=self.seed_base,
            log_mode="cadence+last", eval_fn=be.eval_full)
        state.stage_params = be.split(params)


# ==========================================================================

@dataclass
class SilStagePhase(PhaseBase):
    """Train stage `stage` against its SIL table (paper's left phase); on
    the MLP backend stage 0 only (real inputs)."""
    stage: int = 0
    name: str = "left"
    needs_sil = True

    def run(self, trainer, state) -> None:
        be = trainer.backend
        k = self.stage
        if k >= be.n_stages - 1:
            raise ValueError("SilStagePhase is for interior stages; the last "
                             "stage trains with CE (FrozenPrefixPhase)")
        _mlp_only(be, "SilStagePhase")
        if k != 0:
            raise ValueError("MLP SilStagePhase supports stage 0 only "
                             "(materialize the boundary for later stages)")
        hp = self.resolve(trainer.spec.stage(k))
        opt = make_optimizer_for(hp, trainer.spec)
        state.stage_params[k], _ = trainer.drive_epochs(
            state, step=be.build_sil_step(k, opt, state.sils[k],
                                          accum=hp.accum),
            train_params=state.stage_params[k],
            opt_state=opt.init(state.stage_params[k]), epochs=hp.epochs,
            phase_name=self.name, stage=k, macs_per_sample=be.stage_macs(k),
            seed_base=self.seed_base, log_mode="cadence")


# ==========================================================================

@dataclass
class BoundaryMaterializePhase(PhaseBase):
    """Store the frozen prefix's boundary activations (stages < `upto`).

    This is the paper's single inter-partition communication.  The prefix
    runs over the unshuffled epoch batch by batch, and each batch's
    activations are pulled from the device straight into a reserved
    ``BoundaryCache`` buffer (optionally memmap-spilled to `spill_dir`)."""
    upto: int = 1
    spill_dir: Optional[str] = None
    spill_threshold_bytes: Optional[int] = None
    plan: Optional[object] = None
    name: str = "materialize"

    def _cache(self) -> BoundaryCache:
        kw = {}
        if self.spill_threshold_bytes is not None:
            kw["spill_threshold_bytes"] = self.spill_threshold_bytes
        return BoundaryCache(spill_dir=self.spill_dir, **kw)

    def run(self, trainer, state) -> None:
        be = trainer.backend
        _mlp_only(be, "BoundaryMaterializePhase")
        _no_plan(self.plan, "BoundaryMaterializePhase")
        fwd = be.prefix_forward(self.upto)
        frozen = tuple(state.stage_params[: self.upto])
        old = state.boundary.get("h")
        if old is not None and hasattr(old, "close"):
            old.close()   # re-materialization must not leak a spill file
        cache = self._cache()
        bx, by = be.epoch_arrays(seed=0, shuffle=False)
        nb, bs = bx.shape[0], bx.shape[1]
        cache.reserve(nb * bs, (be.boundary_width(self.upto - 1),),
                      be.boundary_dtype())
        for i in range(nb):
            cache.append(fwd(frozen, bx[i]))
        state.boundary = {"h": cache, "labels": by.reshape(-1).clone()}


# ==========================================================================

@dataclass
class FrozenPrefixPhase(PhaseBase):
    """Train stage `stage` on the stored frozen-prefix boundary with its
    natural loss (CE if it is the last stage, SIL-MSE otherwise).

    source='cache': inputs come from the materialized BoundaryCache (the
    paper's Fig.-3 right phase, no prefix compute while training), uploaded
    once for the whole phase."""
    stage: int = 1
    source: str = "cache"
    plan: Optional[object] = None
    name: str = "right"
    seed_base: int = 100
    needs_sil = True

    def run(self, trainer, state) -> None:
        be = trainer.backend
        k = self.stage
        last = k == be.n_stages - 1
        if not last and not state.sils:
            raise ValueError("interior FrozenPrefixPhase needs SIL tables: "
                             "pass sils= or gen= to Trainer.run")
        _mlp_only(be, "FrozenPrefixPhase")
        _no_plan(self.plan, "FrozenPrefixPhase")
        if self.source != "cache" or "h" not in state.boundary:
            raise ValueError("MLP FrozenPrefixPhase needs a preceding "
                             "BoundaryMaterializePhase (source='cache')")
        hp = self.resolve(trainer.spec.stage(k))
        opt = make_optimizer_for(hp, trainer.spec)
        step = be.build_ce_step(k, opt, accum=hp.accum) if last \
            else be.build_sil_step(k, opt, state.sils[k], accum=hp.accum)
        h = state.boundary["h"].tensor(be.device)
        y = state.boundary["labels"]

        def batch_arrays(ep):
            return be.array_epoch_arrays(h, y, self.seed_base + ep,
                                         be.spec.shuffle)
        state.stage_params[k], _ = trainer.drive_epochs(
            state, step=step, train_params=state.stage_params[k],
            opt_state=opt.init(state.stage_params[k]), epochs=hp.epochs,
            phase_name=self.name, stage=k, macs_per_sample=be.stage_macs(k),
            seed_base=self.seed_base, log_mode="cadence+last",
            batch_arrays=batch_arrays)


# ==========================================================================

@dataclass
class RecoveryPhase(PhaseBase):
    """§5 recovery: fine-tune stage `stage` end-to-end, the rest frozen."""
    stage: int = 0
    name: str = "recovery"
    seed_base: int = 200

    def run(self, trainer, state) -> None:
        be = trainer.backend
        j = self.stage
        base = trainer.spec.recovery
        if base is None and self.epochs is None and self.steps is None:
            return   # recovery disabled in the spec and not forced here
        _mlp_only(be, "RecoveryPhase")
        hp = self.resolve(base or trainer.spec.stage(j))
        if not hp.epochs:
            return
        opt = make_optimizer_for(hp, trainer.spec)
        step = be.build_recovery_step(j, list(state.stage_params), opt,
                                      accum=hp.accum)
        state.stage_params[j], _ = trainer.drive_epochs(
            state, step=step, train_params=state.stage_params[j],
            opt_state=opt.init(state.stage_params[j]), epochs=hp.epochs,
            phase_name=self.name, stage=j, macs_per_sample=be.full_macs(),
            seed_base=self.seed_base, log_mode="every")


# ==========================================================================

@dataclass
class ParallelSilPhase(PhaseBase):
    """Fig. 5: every stage trains at once on synthetic inputs and targets.
    Not ported yet (slice 3 of the port)."""
    name: str = "parallel"
    needs_sil = True

    def run(self, trainer, state) -> None:
        raise NotImplementedError("ParallelSilPhase (paper Fig. 5) is not "
                                  "ported yet")
