"""Composable training phases (the paper's schedule, decomposed), counterpart
of ``repro/train/phases.py``.

Each phase is a small dataclass with ``run(trainer, state)``; a training
procedure is a *list* of phases executed in order over a shared
``TrainState``:

* ``BaselinePhase``            -- conventional end-to-end training.
* ``SilStagePhase``            -- train a stage against its SIL targets
                                  (paper Fig. 3 "left" phase; interior LM
                                  stages consume the live frozen prefix).
* ``BoundaryMaterializePhase`` -- run the frozen prefix over the data once
                                  and store the boundary (the paper's only
                                  communication) in a ``BoundaryCache``.
* ``FrozenPrefixPhase``        -- train a stage on frozen-prefix inputs
                                  (stored, or live for the LM) with its
                                  natural loss (CE for the last stage;
                                  Fig. 3 "right" phase).
* ``RecoveryPhase``            -- §5: fine-tune one stage end-to-end with
                                  the others frozen.
* ``ParallelSilPhase``         -- Fig. 5; not ported yet (raises).

Per-phase ``lr`` / ``optimizer`` / duration default to the ``TrainSpec``'s
per-stage entries (epochs on the MLP backend, steps on the LM backend);
``seed_base`` sets the epoch shuffles as the reference's.  Still raising
``NotImplementedError``: ``plan=`` placement (ROADMAP queue A, parallel
stages), the LM's materialized boundary (``BoundaryMaterializePhase`` and
``FrozenPrefixPhase(source="cache")`` on the LM backend) and
``ParallelSilPhase``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.train.backends import make_optimizer_for
from repro_torch.train.boundary import BoundaryCache
from repro_torch.train.spec import StageSpec


def _mlp_only(be, what: str) -> None:
    if be.kind != "mlp":
        raise NotImplementedError(
            f"{what} on the {be.kind} backend is not ported yet: the LM "
            "trains on the live frozen prefix (FrozenPrefixPhase("
            "source='live')); ROADMAP queue A, parallel stages")


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
        hp = self.resolve(trainer.spec.baseline or trainer.spec.stage(0))
        opt = make_optimizer_for(hp, trainer.spec)
        params = be.join(state.stage_params)
        if be.kind == "mlp":
            params, _ = trainer.drive_epochs(
                state, step=be.build_baseline_step(opt, accum=hp.accum),
                train_params=params, opt_state=opt.init(params),
                epochs=hp.epochs, phase_name=self.name, stage=-1,
                macs_per_sample=be.full_macs(), seed_base=self.seed_base,
                log_mode="cadence+last", eval_fn=be.eval_full)
        else:
            # unpartitioned: the joined tree through M.forward, so the tied
            # embedding also gets the unembedding's gradient
            params, _ = trainer.drive_steps(
                state, step=be.build_baseline_step(opt, accum=hp.accum),
                inputs_fn=lambda i: (be.batch_fn(i),), n_steps=hp.steps,
                phase_name=self.name, stage=-1, train_params=params,
                opt_state=opt.init(params))
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
        hp = self.resolve(trainer.spec.stage(k))
        opt = make_optimizer_for(hp, trainer.spec)
        if be.kind != "mlp":
            sp = state.stage_params[k]
            prefix = be.prefix_forward(k) if k else None
            frozen = tuple(state.stage_params[:k])

            def inputs(i):
                batch = be.batch_fn(i)
                xin = batch if k == 0 else prefix(frozen, batch)
                return (xin, batch["labels"], batch.get("mask"))
            state.stage_params[k], _ = trainer.drive_steps(
                state, step=be.build_stage_step(k, opt, state.sils[k],
                                                accum=hp.accum),
                inputs_fn=inputs, n_steps=hp.steps, phase_name=self.name,
                stage=k, train_params=sp,
                opt_state=opt.init(be.trainable(sp)))
            return
        if k != 0:
            raise ValueError("MLP SilStagePhase supports stage 0 only "
                             "(materialize the boundary for later stages)")
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
    once for the whole phase; the MLP backend only.
    source='live': the frozen prefix runs forward every step (under
    ``torch.no_grad()``), the transformer-sequential default, where data is
    a stream; the LM backend only."""
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
        _no_plan(self.plan, "FrozenPrefixPhase")
        hp = self.resolve(trainer.spec.stage(k))
        opt = make_optimizer_for(hp, trainer.spec)
        if be.kind != "mlp":
            if self.source != "live":
                raise NotImplementedError(
                    "FrozenPrefixPhase(source='cache') on the LM backend "
                    "needs BoundaryMaterializePhase's LM branch, which is "
                    "not ported yet (ROADMAP queue A, parallel stages); use "
                    "source='live'")
            be.before_stage_train(state.stage_params, k)
            sp = state.stage_params[k]
            prefix = be.prefix_forward(k)
            frozen = tuple(state.stage_params[:k])

            def inputs(i):
                batch = be.batch_fn(i)
                return (prefix(frozen, batch), batch["labels"],
                        batch.get("mask"))
            state.stage_params[k], _ = trainer.drive_steps(
                state, step=be.build_stage_step(
                    k, opt, None if last else state.sils[k], accum=hp.accum),
                inputs_fn=inputs, n_steps=hp.steps, phase_name=self.name,
                stage=k, train_params=sp,
                opt_state=opt.init(be.trainable(sp)))
            return
        if self.source != "cache" or "h" not in state.boundary:
            raise ValueError("MLP FrozenPrefixPhase needs a preceding "
                             "BoundaryMaterializePhase (source='cache')")
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
        hp = self.resolve(base or trainer.spec.stage(j))
        n = hp.epochs if be.kind == "mlp" else hp.steps
        if not n:
            return
        opt = make_optimizer_for(hp, trainer.spec)
        step = be.build_recovery_step(j, list(state.stage_params), opt,
                                      accum=hp.accum)
        if be.kind != "mlp":
            sp = state.stage_params[j]
            state.stage_params[j], _ = trainer.drive_steps(
                state, step=step, inputs_fn=lambda i: (be.batch_fn(i),),
                n_steps=n, phase_name=self.name,
                stage=-1,                  # the reference logs recovery as -1
                train_params=sp, opt_state=opt.init(be.trainable(sp)))
            return
        state.stage_params[j], _ = trainer.drive_epochs(
            state, step=step, train_params=state.stage_params[j],
            opt_state=opt.init(state.stage_params[j]), epochs=hp.epochs,
            phase_name=self.name, stage=j, macs_per_sample=be.full_macs(),
            seed_base=self.seed_base, log_mode="every")


# ==========================================================================

@dataclass
class ParallelSilPhase(PhaseBase):
    """Fig. 5: every stage trains at once on synthetic inputs and targets.
    Not ported yet (ROADMAP queue A: parallel stages and durability)."""
    name: str = "parallel"
    needs_sil = True

    def run(self, trainer, state) -> None:
        raise NotImplementedError("ParallelSilPhase (paper Fig. 5) is not "
                                  "ported yet")
