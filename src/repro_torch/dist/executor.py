"""The stage executor (counterpart of ``repro/dist/executor.py``):
``StageExecutor`` runs a backend's stages per a ``PlacementPlan``.

* **Pin once, up front.** Each stage's params are copied ``.to`` its
  device; its optimizer state is initialised from those copies, so it lives
  there too; the SIL tables a stage reads are placed on its device
  (SIL_{k-1} as its input, SIL_k as its target; on the device they are
  already on, that is no copy).
* **No host synchronisation inside a tick.** ``tick(i)`` launches every due
  stage's step and returns: nothing calls ``.item()``, ``.cpu()`` or
  ``synchronize``.  An LM batch goes to each stage's device from pinned
  memory without blocking; LM losses stay device scalars until ``finalize``
  reads them, one stacked read per device (``Trainer.flush_losses``); an
  MLP tick is one epoch of a stage's steps, its losses a device tensor.
* **Independent per-stage progress.** ``ticks[k]`` counts how far stage k
  has come.  ``run(n, stages=[k])`` replays only stage k on data that
  depends only on the tick (``LMBackend.host_batch(i)``, the MLP's seeded
  epoch gather), which is how a failed stage catches up after
  ``resume_stage(k)`` without touching the others; ``_metrics_upto`` keeps
  a replayed tick from logging its loss or MACs twice.

With every stage on one device this runs the ``ParallelSilPhase`` loop's
kernels in the same order, so the results are bitwise equal to it.  The
reference also feeds a device-resident loss histogram; the port has none
(the losses reach the trainer's host ``train_loss`` histogram at
``finalize``, as the LM phases do).  ``batch_hook(stage, tick, batch)``,
when set, rewrites every stage's host batch before it is placed (the seam
the reference's fault injectors use).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.dist import lifecycle
from repro_torch.dist.placement import PlacementPlan
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TID_STAGE0, Tracer
from repro_torch.train.backends import epoch_fn
from repro_torch.tree import tree_map


class StageExecutor:
    """Runs all stages of one backend per the placement plan."""

    def __init__(self, backend, placement: PlacementPlan,
                 stage_params: Sequence, sils: Sequence, opts: Sequence,
                 hps: Sequence, *, seed_base: int = 0, shuffle: bool = True,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_keep_last: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        placement.validate(backend.n_stages)
        self.be = backend
        self.placement = placement
        self.opts = list(opts)
        self.hps = list(hps)
        self.seed_base = seed_base
        self.shuffle = shuffle
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every or 0)
        self.ckpt_keep_last = ckpt_keep_last
        self.batch_hook = None
        n = self.n = backend.n_stages
        self.devices = [torch.device(placement.device_for(k))
                        for k in range(n)]
        self.params = [tree_map(lambda t, d=d: t.detach().to(d, copy=True),
                                stage_params[k])
                       for k, d in enumerate(self.devices)]
        self.opt_states = [self.opts[k].init(backend.trainable(self.params[k]))
                           for k in range(n)]
        self.ticks: List[int] = [0] * n
        self.cum_macs = 0
        self._global_ticks = 0
        self._metrics_upto: List[int] = [0] * n
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self._ticks_counter = self.metrics.counter(
            "executor_ticks_total", help="dispatched stage ticks, by stage")
        self._pending: list = []          # LM: device loss scalars
        self._logged_steps: list = []
        self._logged_stages: list = []
        self._losses: List[list] = [[] for _ in range(n)]   # MLP: per tick
        if backend.kind == "mlp":
            self._fns = [epoch_fn(backend.build_parallel_step(
                k, self.opts[k], [s.to(d) for s in sils],
                accum=self.hps[k].accum))
                for k, d in enumerate(self.devices)]
        else:
            self._fns = []
            for k, d in enumerate(self.devices):
                sil_t = None if k == n - 1 else sils[k].to(d)
                if k == 0:
                    self._fns.append(backend.build_stage_step(
                        0, self.opts[0], sil_t, accum=self.hps[0].accum))
                else:
                    self._fns.append(backend.build_parallel_stage_step(
                        k, self.opts[k], sils[k - 1].to(d), sil_t,
                        accum=self.hps[k].accum))

    # -- tick dispatch -----------------------------------------------------

    def _duration(self, k: int) -> int:
        hp = self.hps[k]
        return hp.epochs if self.be.kind == "mlp" else hp.steps

    def tick(self, i: int, stages: Optional[Sequence[int]] = None) -> None:
        """Launch tick ``i`` (an epoch on the MLP, a step on the LM) of every
        listed stage that is at tick ``i`` and within its duration.
        Returns without waiting on any device."""
        ks = range(self.n) if stages is None else stages
        ks = [k for k in ks if self.ticks[k] == i and i < self._duration(k)]
        if not ks:
            return
        if self.be.kind == "mlp":
            self._tick_mlp(i, ks)
        else:
            self._tick_lm(i, ks)
        self._global_ticks = max(self._global_ticks, i + 1)

    def _tick_mlp(self, ep: int, ks: Sequence[int]) -> None:
        be = self.be
        batches = be.epoch_arrays(self.seed_base + ep, self.shuffle)
        n_samples = batches[0].shape[0] * batches[0].shape[1]
        for k in ks:
            bk = batches if self.batch_hook is None \
                else self.batch_hook(k, ep, batches)
            bk = tuple(b.to(self.devices[k], non_blocking=True) for b in bk)
            with self.tracer.span(f"tick {ep}", cat="stage",
                                  tid=TID_STAGE0 + k, stage=k, tick=ep):
                self.params[k], self.opt_states[k], losses = self._fns[k](
                    self.params[k], self.opt_states[k], bk)
            if ep >= self._metrics_upto[k]:
                self.cum_macs += be.stage_macs(k) * n_samples
                self._losses[k].append(losses)
                self._ticks_counter.inc(1, stage=k)
                self._metrics_upto[k] = ep + 1
            self.ticks[k] = ep + 1

    def _tick_lm(self, i: int, ks: Sequence[int]) -> None:
        be = self.be
        batch = be.host_batch(i)
        for k in ks:
            dev = self.devices[k]
            bk = batch if self.batch_hook is None \
                else self.batch_hook(k, i, batch)
            with self.tracer.span(f"tick {i}", cat="stage",
                                  tid=TID_STAGE0 + k, stage=k, tick=i):
                if k == 0:
                    b0 = be.put_batch(bk, dev)
                    self.params[0], self.opt_states[0], loss = self._fns[0](
                        self.params[0], self.opt_states[0], b0, b0["labels"])
                else:
                    labels = be.put_batch({"labels": bk["labels"]},
                                          dev)["labels"]
                    self.params[k], self.opt_states[k], loss = self._fns[k](
                        self.params[k], self.opt_states[k], labels)
            if i >= self._metrics_upto[k]:
                self._pending.append(loss)
                self._ticks_counter.inc(1, stage=k)
                self._logged_steps.append(i)
                self._logged_stages.append(k)
                self._metrics_upto[k] = i + 1
            self.ticks[k] = i + 1

    def run(self, n_ticks: int, stages: Optional[Sequence[int]] = None
            ) -> "StageExecutor":
        """Advance the listed stages (default: all) up to ``n_ticks``,
        checkpointing every ``ckpt_every`` ticks when a ``ckpt_dir`` is
        set.  A resumed stage starts from its own tick counter."""
        ks = list(range(self.n)) if stages is None else list(stages)
        start = min(self.ticks[k] for k in ks)
        for i in range(start, n_ticks):
            self.tick(i, stages=ks)
            if self.ckpt_dir and self.ckpt_every \
                    and (i + 1) % self.ckpt_every == 0:
                self.checkpoint(stages=ks)
        return self

    # -- lifecycle ---------------------------------------------------------

    def checkpoint(self, stages: Optional[Sequence[int]] = None) -> None:
        """One manifest per stage, at each stage's OWN tick counter."""
        if not self.ckpt_dir:
            raise ValueError("executor built without ckpt_dir")
        for k in (range(self.n) if stages is None else stages):
            lifecycle.save_stage(
                self.ckpt_dir, k, self.ticks[k], self.params[k],
                self.opt_states[k],
                metadata={"device": str(self.devices[k]),
                          "placement": self.placement.strategy,
                          "kind": self.be.kind},
                keep_last=self.ckpt_keep_last)

    def resume_stage(self, k: int, step: Optional[int] = None) -> int:
        """Reload stage k (params, optimizer state, tick counter) from its
        own checkpoints onto its own device.  The other stages are not
        touched; follow with ``run(n, stages=[k])`` to replay the lost
        ticks."""
        params, opt_state, tick = lifecycle.restore_stage(
            self.ckpt_dir, k, like_params=self.params[k],
            like_opt=self.opt_states[k], step=step, device=self.devices[k])
        self.params[k], self.opt_states[k] = params, opt_state
        self.ticks[k] = tick
        return tick

    # -- drain / handoff ---------------------------------------------------

    def gather(self) -> list:
        """Per-stage params on the backend's device, as copies: the
        optimizers go on updating the executor's own in place."""
        return [tree_map(lambda t: t.to(self.be.device, copy=True), p)
                for p in self.params]

    def finalize(self, trainer, state, phase_name: str = "parallel") -> None:
        """Hand the results to the TrainState: params on the backend's
        device, the MACs folded in, the losses read (once per device on the
        LM, once per stage on the MLP) into the History and the trainer's
        loss histogram, the MLP's joined accuracy logged."""
        state.stage_params = self.gather()
        state.cum_macs += self.cum_macs
        self.cum_macs = 0
        if self.be.kind == "mlp":
            for k, losses in enumerate(self._losses):
                if losses:
                    trainer.log_epoch_losses(state, losses, phase_name, k)
            self._losses = [[] for _ in range(self.n)]
            state.history.log(phase=phase_name, stage=-1,
                              step=state.step_idx, macs=state.cum_macs,
                              acc=self.be.eval_joined(state.stage_params))
        else:
            state.step_idx += self._global_ticks
            trainer.flush_losses(state, self._pending, self._logged_steps,
                                 phase_name, self._logged_stages)
            self._pending, self._logged_steps, self._logged_stages = \
                [], [], []
        for k in range(self.n):
            trainer.note_skipped(state, self.opt_states[k], phase_name, k)
        self.metrics.drain()
