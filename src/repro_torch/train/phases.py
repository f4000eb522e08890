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
* ``ParallelSilPhase``         -- Fig. 5: every stage trains at once on
                                  synthetic inputs and targets, with no
                                  dependency between stages; with
                                  ``plan=`` through ``repro_torch.dist``'s
                                  ``StageExecutor``.

Per-phase ``lr`` / ``optimizer`` / duration default to the ``TrainSpec``'s
per-stage entries (epochs on the MLP backend, steps on the LM backend);
``seed_base`` sets the epoch shuffles as the reference's.  ``plan=`` (a
``repro_torch.dist`` ``PlacementPlan``, a strategy name or an assignment
list, with ``devices=``) places stages on devices.  On the LM backend
the materialized boundary holds ``n_batches`` batches of (B, S, d) rows in
the activation dtype, and ``FrozenPrefixPhase(source="cache")`` uploads
one batch a step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.train.backends import epoch_fn, make_optimizer_for
from repro_torch.train.boundary import BoundaryCache, to_device
from repro_torch.train.spec import StageSpec
from repro_torch.tree import tree_map


def _resolve_placement(plan, devices, trainer, state):
    """Plan, strategy name or assignment list -> a validated
    ``repro_torch.dist`` ``PlacementPlan``.  The ``"memory"`` strategy's
    bytes come from the LIVE stage trees and each stage's configured
    optimizer (computed only when that strategy is chosen)."""
    from repro_torch.dist import placement as P
    be = trainer.backend

    def stage_bytes():
        return [P.estimate_stage_bytes(state.stage_params[k],
                                       trainer.spec.stage(k).optimizer)
                for k in range(be.n_stages)]
    return P.resolve(plan, be.n_stages, devices=devices,
                     stage_bytes=stage_bytes)


def _to(tree, device):
    """``tree`` on ``device`` (the same tensors where they are there)."""
    return tree_map(lambda t: t.to(device), tree)


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
    ``BoundaryCache`` buffer (optionally memmap-spilled to `spill_dir`).
    LM backend: ``n_batches`` batches of the stream, batch j being
    ``batch_fn(state.step_idx + j)`` (the steps a following
    ``FrozenPrefixPhase(source="cache")`` takes), with their labels and
    mask kept on the host.

    With a ``plan`` the frozen prefix runs as the PRODUCER on the device
    of stage ``upto - 1``; paired with ``FrozenPrefixPhase(plan=...)`` the
    paper's one communication becomes a hop between devices."""
    upto: int = 1
    spill_dir: Optional[str] = None
    spill_threshold_bytes: Optional[int] = None
    n_batches: Optional[int] = None    # LM backend only
    plan: Optional[object] = None
    devices: Optional[Sequence] = None
    name: str = "materialize"

    def _cache(self) -> BoundaryCache:
        kw = {}
        if self.spill_threshold_bytes is not None:
            kw["spill_threshold_bytes"] = self.spill_threshold_bytes
        return BoundaryCache(spill_dir=self.spill_dir, **kw)

    def run(self, trainer, state) -> None:
        be = trainer.backend
        if be.kind != "mlp" and be.cfg.enc_dec:
            raise NotImplementedError(
                "boundary materialization for enc-dec payloads is not "
                "supported; use FrozenPrefixPhase(source='live')")
        if be.kind != "mlp" and not self.n_batches:
            raise ValueError("LM materialization needs n_batches")
        fwd = be.prefix_forward(self.upto)
        frozen = tuple(state.stage_params[: self.upto])
        producer = be.device
        if self.plan is not None:
            producer = _resolve_placement(self.plan, self.devices, trainer,
                                          state).device_for(self.upto - 1)
            frozen = tuple(_to(sp, producer) for sp in frozen)
        old = state.boundary.get("h")
        if old is not None and hasattr(old, "close"):
            old.close()   # re-materialization must not leak a spill file
        cache = self._cache()
        if be.kind != "mlp":
            state.boundary = self._run_lm(be, fwd, frozen, producer, cache,
                                          state.step_idx)
            return
        bx, by = be.epoch_arrays(seed=0, shuffle=False)
        nb, bs = bx.shape[0], bx.shape[1]
        cache.reserve(nb * bs, (be.boundary_width(self.upto - 1),),
                      be.boundary_dtype())
        for i in range(nb):
            cache.append(fwd(frozen, bx[i].to(producer)))
        state.boundary = {"h": cache, "labels": by.reshape(-1).clone()}

    def _run_lm(self, be, fwd, frozen, producer, cache, step0: int) -> dict:
        """The stream's batches ``step0 .. step0 + n_batches - 1`` through
        the frozen prefix; the (n_batches * B, S, d) buffer is reserved on
        the first.  Labels and mask are the host batches' own."""
        labels, masks = [], []
        for j in range(self.n_batches):
            host = be.host_batch(step0 + j)
            h = fwd(frozen, be.put_batch(host, producer))
            if j == 0:
                b, s, d = h.shape
                cache.reserve(self.n_batches * b, (s, d),
                              be.boundary_dtype())
            cache.append(h)
            labels.append(host["labels"])
            if "mask" in host:
                masks.append(host["mask"])
        return {"h": cache, "labels": torch.cat(labels),
                "mask": torch.cat(masks) if masks else None,
                "batch_size": b}


# ==========================================================================

@dataclass
class FrozenPrefixPhase(PhaseBase):
    """Train stage `stage` on the stored frozen-prefix boundary with its
    natural loss (CE if it is the last stage, SIL-MSE otherwise).

    source='cache': inputs come from the materialized BoundaryCache (the
    paper's Fig.-3 right phase, no prefix compute while training).  The MLP
    uploads it once for the phase; the LM uploads one batch a step, global
    step i taking the cache's batch i % n_batches with its labels and mask.
    source='live': the frozen prefix runs forward every step (under
    ``torch.no_grad()``), the transformer-sequential default, where data is
    a stream; the LM backend only.

    With a ``plan`` the trained stage lives on its device as the CONSUMER;
    under source='live' the frozen prefix runs as the PRODUCER on the
    device of stage k - 1 and each boundary activation moves producer ->
    consumer with ``.to`` (the paper's one communication, as a transfer).
    The trained stage comes back to the backend's device at the end."""
    stage: int = 1
    source: str = "cache"
    plan: Optional[object] = None
    devices: Optional[Sequence] = None
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
        hp = self.resolve(trainer.spec.stage(k))
        opt = make_optimizer_for(hp, trainer.spec)
        if be.kind != "mlp":
            be.before_stage_train(state.stage_params, k)
        consumer = producer = None
        if self.plan is not None:
            placement = _resolve_placement(self.plan, self.devices, trainer,
                                           state)
            consumer = placement.device_for(k)
            producer = placement.device_for(k - 1) if k > 0 else consumer
        train_params = state.stage_params[k]
        sil = None if last else state.sils[k]
        if consumer is not None:
            train_params = _to(train_params, consumer)
            sil = None if sil is None else sil.to(consumer)
        if be.kind != "mlp":
            if self.source == "cache":
                inputs = _cached_inputs(state.boundary,
                                        be.device if consumer is None
                                        else consumer)
            else:
                inputs = _live_inputs(be, k, state.stage_params[:k],
                                      producer, consumer)
            train_params, _ = trainer.drive_steps(
                state, step=be.build_stage_step(k, opt, sil, accum=hp.accum),
                inputs_fn=inputs, n_steps=hp.steps, phase_name=self.name,
                stage=k, train_params=train_params,
                opt_state=opt.init(be.trainable(train_params)))
        else:
            if self.source != "cache" or "h" not in state.boundary:
                raise ValueError("MLP FrozenPrefixPhase needs a preceding "
                                 "BoundaryMaterializePhase (source='cache')")
            step = be.build_ce_step(k, opt, accum=hp.accum) if last \
                else be.build_sil_step(k, opt, sil, accum=hp.accum)
            home = be.device if consumer is None else consumer
            h = state.boundary["h"].tensor(home)
            y = state.boundary["labels"].to(home)

            def batch_arrays(ep):
                return be.array_epoch_arrays(h, y, self.seed_base + ep,
                                             be.spec.shuffle)
            eval_fn = None
            if consumer is not None:
                def eval_fn(tp):
                    sp = list(state.stage_params)
                    sp[k] = _to(tp, be.device)
                    return be.eval_joined(sp)
            train_params, _ = trainer.drive_epochs(
                state, step=step, train_params=train_params,
                opt_state=opt.init(train_params), epochs=hp.epochs,
                phase_name=self.name, stage=k,
                macs_per_sample=be.stage_macs(k), seed_base=self.seed_base,
                log_mode="cadence+last", eval_fn=eval_fn,
                batch_arrays=batch_arrays)
        state.stage_params[k] = train_params if consumer is None \
            else _to(train_params, be.device)


def _live_inputs(be, k: int, prefix_params, producer, consumer):
    """``inputs(i)`` of the LM's right phase on the live frozen prefix:
    stages < k run forward on step i's batch (on ``producer`` when placed)
    and the boundary moves to ``consumer``."""
    prefix = be.prefix_forward(k)
    frozen = tuple(prefix_params)
    if producer is not None:
        frozen = tuple(_to(sp, producer) for sp in frozen)

    def inputs(i):
        batch = be.batch_fn(i, producer)
        out = (prefix(frozen, batch), batch["labels"], batch.get("mask"))
        if consumer is None:
            return out
        # the paper's one inter-partition communication, as a producer ->
        # consumer transfer (an encoder-decoder's payload (x, enc_out) whole)
        return tuple(None if t is None else _to(t, consumer) for t in out)
    return inputs


def _cached_inputs(boundary: dict, device):
    """``inputs(i)`` of the LM's right phase on the stored boundary: global
    step i takes rows ``j = (i % n_batches) * b`` to ``j + b`` with their
    labels and mask, one batch uploaded a step (the reference's indexing)."""
    if "h" not in boundary:
        raise ValueError("no materialized boundary; add a "
                         "BoundaryMaterializePhase first")
    cache, labels = boundary["h"], boundary["labels"]
    mask, b = boundary.get("mask"), boundary["batch_size"]
    n_batches = cache.n_rows // b

    def inputs(i):
        j = (i % n_batches) * b
        return (cache.rows(j, j + b, device),
                to_device(labels[j:j + b], device),
                None if mask is None else to_device(mask[j:j + b], device))
    return inputs


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
    """Fig. 5: every stage trains at once, with no dependency between them.

    Stage 0 consumes the real inputs; stage k > 0 consumes SIL_{k-1}[:, y]
    and regresses to SIL_k[:, y]; the last stage trains with CE.  (The
    paper deems the mode impractical for accuracy; it is the zero-
    communication extreme of the schedule space.)  As in the reference, the
    LM's last stage trains against the frozen tied-unembedding copy it was
    split with: this phase does not refresh it from stage 0's embedding
    (``before_stage_train``), since no stage waits for another.

    ``plan`` (a ``repro_torch.dist`` PlacementPlan, ``'round_robin'`` /
    ``'memory'``, or an explicit assignment list, over ``devices``) routes
    the phase through ``repro_torch.dist.StageExecutor``: every stage's
    params, optimizer state and SIL tables pinned to its device, every
    stage's step launched per tick with no host sync.  With all stages on
    one device it is bitwise equal to the loop without ``plan``.
    ``ckpt_dir`` / ``ckpt_every`` / ``ckpt_keep_last`` checkpoint each
    stage on its own (one manifest and tick counter per stage;
    ``repro_torch.dist.lifecycle``)."""
    name: str = "parallel"
    needs_sil = True
    shuffle: bool = True           # the reference's MLP Fig.-5 shuffles
    plan: Optional[object] = None
    devices: Optional[Sequence] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    ckpt_keep_last: Optional[int] = None

    def run(self, trainer, state) -> None:
        be = trainer.backend
        if self.plan is not None:
            self._run_dist(trainer, state)
        elif be.kind == "mlp":
            self._run_mlp(trainer, state)
        else:
            self._run_lm(trainer, state)

    def _stage_hps(self, trainer):
        hps = [self.resolve(trainer.spec.stage(k))
               for k in range(trainer.backend.n_stages)]
        return hps, [make_optimizer_for(hp, trainer.spec) for hp in hps]

    def _run_dist(self, trainer, state) -> None:
        from repro_torch.dist.executor import StageExecutor
        be = trainer.backend
        placement = _resolve_placement(self.plan, self.devices, trainer,
                                       state)
        hps, opts = self._stage_hps(trainer)
        ex = StageExecutor(be, placement, state.stage_params, state.sils,
                           opts, hps, seed_base=self.seed_base,
                           shuffle=self.shuffle, ckpt_dir=self.ckpt_dir,
                           ckpt_every=self.ckpt_every,
                           ckpt_keep_last=self.ckpt_keep_last,
                           metrics=trainer.metrics, tracer=trainer.tracer)
        state.stage_params = None   # the executor owns the stages until
        #                             finalize hands them back
        if be.kind == "mlp":
            n_ticks = max(hp.epochs for hp in hps)
        else:
            n_ticks = max(hp.steps for hp in hps)
        ex.run(n_ticks)
        if self.ckpt_dir:
            ex.checkpoint()    # final per-stage manifests at their ticks
        ex.finalize(trainer, state, phase_name=self.name)

    def _run_mlp(self, trainer, state) -> None:
        be = trainer.backend
        hps, opts = self._stage_hps(trainer)
        opt_states = [opts[k].init(state.stage_params[k])
                      for k in range(be.n_stages)]
        epoch_fns = [epoch_fn(be.build_parallel_step(
            k, opts[k], state.sils, accum=hps[k].accum))
            for k in range(be.n_stages)]
        losses: list = [[] for _ in range(be.n_stages)]
        # the epoch loop outside the stage loop: the (shuffled) epoch
        # gather is done once per epoch, shared by every stage
        for ep in range(max(hp.epochs for hp in hps)):
            batches = be.epoch_arrays(self.seed_base + ep, self.shuffle)
            n_samples = batches[0].shape[0] * batches[0].shape[1]
            for k in range(be.n_stages):
                if ep >= hps[k].epochs:
                    continue
                state.stage_params[k], opt_states[k], ls = epoch_fns[k](
                    state.stage_params[k], opt_states[k], batches)
                losses[k].append(ls)
                state.cum_macs += be.stage_macs(k) * n_samples
        for k, ls in enumerate(losses):
            if ls:
                trainer.log_epoch_losses(state, ls, self.name, k)
        state.history.log(phase=self.name, stage=-1, step=state.step_idx,
                          macs=state.cum_macs,
                          acc=be.eval_joined(state.stage_params))

    def _run_lm(self, trainer, state) -> None:
        be = trainer.backend
        n = be.n_stages
        hps, opts = self._stage_hps(trainer)
        opt_states = [opts[k].init(be.trainable(state.stage_params[k]))
                      for k in range(n)]
        steps = [be.build_stage_step(k, opts[k],
                                     None if k == n - 1 else state.sils[k],
                                     accum=hps[k].accum)
                 for k in range(n)]
        pending, logged_steps, logged_stages = [], [], []
        for i in range(max(hp.steps for hp in hps)):
            batch = be.batch_fn(i)
            labels = batch["labels"]
            for k in range(n):
                if i >= hps[k].steps:
                    continue
                xin = batch if k == 0 else be.synthetic_input(k, state.sils,
                                                              labels)
                state.stage_params[k], opt_states[k], loss = steps[k](
                    state.stage_params[k], opt_states[k], xin, labels)
                pending.append(loss)       # a device scalar, read at the end
                logged_steps.append(i)
                logged_stages.append(k)
            state.step_idx += 1
        trainer.flush_losses(state, pending, logged_steps, self.name,
                             logged_stages)
