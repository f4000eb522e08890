"""The paper's training procedures as phase lists (counterpart of
``repro/train/recipes.py``):

    baseline   [BaselinePhase()]
    Fig. 3     [SilStagePhase(0), BoundaryMaterializePhase(1),
                FrozenPrefixPhase(1), RecoveryPhase(0)]
    LM seq.    [SilStagePhase(k) for interior k] + [FrozenPrefixPhase(last,
                source='live'), RecoveryPhase(0)]
    Fig. 5     [ParallelSilPhase()]   (every stage at once; ``dist=``
                places the stages through ``repro_torch.dist``)

``run_mlp_baseline`` and ``run_mlp_fig3`` draw the params (then the SIL
table) from a ``torch.Generator``, or take them as ``params=`` / ``sil=``:
torch cannot reproduce the reference's threefry key schedule, so the
conformance tests pass the reference's arrays across
(``repro_torch.convert``).  They run on the card unless ``device="cpu"``.
``run_lm_sequential`` does the same for the transformer: params as given,
SIL tables from ``gen`` unless passed as ``sils=``.  ``run_mlp_fig5`` and
``run_lm_parallel`` run Fig. 5 likewise; ``dist=`` / ``dist_devices=`` /
``ckpt_dir=`` / ``ckpt_every=`` route it through the stage executor with
per-stage checkpoints.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from repro_torch.core import partition, sil as sil_lib
from repro_torch.models import mlp as MLP
from repro_torch.obs.trace import Tracer
from repro_torch.train.backends import LMBackend, MLPBackend, balanced_bounds
from repro_torch.train.phases import (BaselinePhase, BoundaryMaterializePhase,
                                      FrozenPrefixPhase, ParallelSilPhase,
                                      RecoveryPhase, SilStagePhase)
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.train.trainer import Trainer


def baseline_phases() -> list:
    return [BaselinePhase()]


def fig3_phases(n_stages: int = 2) -> list:
    """Paper Fig. 3 + §5: left-vs-SIL, one boundary materialization, right
    on stored activations, recovery.  (n_stages=2 is the paper's setup.)"""
    return [SilStagePhase(stage=0),
            BoundaryMaterializePhase(upto=n_stages - 1),
            FrozenPrefixPhase(stage=n_stages - 1, source="cache"),
            RecoveryPhase(stage=0)]


def lm_sequential_phases(n_stages: int, recovery: bool = True) -> list:
    """Transformer stage-sequential PNN: interior stages against their SIL
    on the live frozen prefix, the last stage with CE on the live frozen
    prefix, then §5."""
    phases: list = [SilStagePhase(stage=k) for k in range(n_stages - 1)]
    phases.append(FrozenPrefixPhase(stage=n_stages - 1, source="live"))
    if recovery:
        phases.append(RecoveryPhase(stage=0))
    return phases


def fig5_phases(*, dist=None, dist_devices=None, ckpt_dir=None,
                ckpt_every: int = 0) -> list:
    """Paper Fig. 5: every stage at once on synthetic inputs and targets."""
    return [ParallelSilPhase(plan=dist, devices=dist_devices,
                             ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)]


def paper_spec(*, n_left: int = 5, n_right: int = 160, n_baseline: int = 40,
               n_recovery: int = 10, lr: float = 0.01, lr_right: float = 0.003,
               lr_recovery: float = 3e-4, batch_size: int = 1410,
               kappa: float = 10.0, momentum: float = 0.9,
               shuffle: bool = True) -> TrainSpec:
    """The paper's §3-§5 hyperparameters as one TrainSpec (defaults are the
    published values; shrink the epoch counts for reduced-fidelity runs).

    shuffle defaults True: with the fixed epoch order the momentum baseline
    oscillates instead of converging on the synthetic EMNIST stand-in."""
    return TrainSpec(
        kappa=kappa, batch_size=batch_size, shuffle=shuffle,
        stages=(StageSpec(epochs=n_left, lr=lr, optimizer="sgdm",
                          momentum=momentum),
                StageSpec(epochs=n_right, lr=lr_right, optimizer="sgdm",
                          momentum=momentum)),
        baseline=StageSpec(epochs=n_baseline, lr=lr, optimizer="sgdm",
                           momentum=momentum),
        recovery=StageSpec(epochs=n_recovery, lr=lr_recovery,
                           optimizer="sgdm", momentum=momentum))


def _gen(gen: Optional[torch.Generator]) -> torch.Generator:
    return gen if gen is not None else torch.Generator().manual_seed(0)


def run_mlp_baseline(cfg: MLP.MLPConfig, data, spec: TrainSpec,
                     gen: Optional[torch.Generator] = None,
                     eval_every: int = 1, *, params=None, device="cuda",
                     tracer: Optional[Tracer] = None):
    """Conventional end-to-end training.  Returns (params, History);
    ``tracer`` receives one span per phase."""
    spec = replace(spec, eval_every=eval_every)
    backend = MLPBackend(cfg, data, spec, device=device)
    if params is None:
        params = MLP.init_params(cfg, _gen(gen), device=backend.device)
    return Trainer(backend, spec, tracer=tracer).run(
        baseline_phases(), params=params)


def run_mlp_fig3(cfg: MLP.MLPConfig, data, spec: TrainSpec,
                 gen: Optional[torch.Generator] = None,
                 eval_every: int = 1, *, bounds=None, params=None, sil=None,
                 device="cuda", tracer: Optional[Tracer] = None):
    """Fig. 3 (+ §5 recovery when spec.recovery has epochs).  Params, then
    the cut's SIL table, are drawn from ``gen`` unless given.  Returns
    (params, History); ``tracer`` receives one span per phase."""
    spec = replace(spec, eval_every=eval_every)
    backend = MLPBackend(cfg, data, spec, bounds=bounds, device=device)
    gen = _gen(gen)
    if params is None:
        params = MLP.init_params(cfg, gen, device=backend.device)
    if sil is None:
        sil = sil_lib.make_sil(gen, backend.boundary_width(0), cfg.n_classes,
                               spec.kappa, device=backend.device)
    return Trainer(backend, spec, tracer=tracer).run(
        fig3_phases(backend.n_stages), params=params, sils=[sil])


def run_mlp_fig5(cfg: MLP.MLPConfig, data, spec: TrainSpec,
                 gen: Optional[torch.Generator] = None, n_stages: int = 3, *,
                 bounds=None, params=None, sils=None, dist=None,
                 dist_devices=None, ckpt_dir=None, ckpt_every: int = 0,
                 device="cuda", tracer: Optional[Tracer] = None):
    """Fig. 5 on the MLP: ``n_stages`` stages (a balanced layer split unless
    ``bounds`` are given) train at once for their ``spec.stages`` epochs.
    Params, then one SIL table per cut, are drawn from ``gen`` unless
    given.  ``dist`` (a ``repro_torch.dist`` PlacementPlan or strategy
    name, over ``dist_devices``) routes the phase through the stage
    executor; ``ckpt_dir`` / ``ckpt_every`` checkpoint each stage.  Returns
    (params, History)."""
    backend = MLPBackend(cfg, data, spec,
                         bounds=bounds if bounds is not None
                         else balanced_bounds(cfg, n_stages), device=device)
    gen = _gen(gen)
    if params is None:
        params = MLP.init_params(cfg, gen, device=backend.device)
    if sils is None:
        sils = backend.make_sils(gen, spec.kappa)
    return Trainer(backend, spec, tracer=tracer).run(
        fig5_phases(dist=dist, dist_devices=dist_devices, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every), params=params, sils=sils)


# --------------------------------------------------------------------------
# transformer entry points
# --------------------------------------------------------------------------

def resolve_plan(cfg, plan) -> partition.PartitionPlan:
    """A PartitionPlan as it is, or a spec for one: an int (the uniform
    K-way split) or ``"auto"`` / ``"auto:K"`` (the ``repro_torch.plan``
    searched cut).  Both LM entry points route through this, so callers can
    hand the CLI's ``--stages`` string straight in."""
    from repro_torch.plan import parse_stages
    if isinstance(plan, partition.PartitionPlan):
        return plan
    strategy, k = parse_stages(plan)
    return partition.make_plan(cfg, k, strategy=strategy)


def run_lm_sequential(cfg, plan, params, batch_fn, spec: TrainSpec,
                      gen: Optional[torch.Generator] = None, *, sils=None,
                      device="cuda", tracer: Optional[Tracer] = None):
    """Stage-sequential PNN over a PartitionPlan (``plan`` may also be an
    int or ``"auto[:K]"``, see ``resolve_plan``):
    ``lm_sequential_phases``, with §5 recovery when ``spec.recovery`` has
    steps.  ``batch_fn(i)`` gives step i's batch; the SIL tables come from
    ``gen`` (class-major, see ``LMBackend.make_sils``) unless ``sils`` are
    given.  Returns (joined params, History)."""
    plan = resolve_plan(cfg, plan)
    backend = LMBackend(cfg, plan, batch_fn, spec, device=device)
    recovery = bool(spec.recovery and spec.recovery.steps)
    return Trainer(backend, spec, tracer=tracer).run(
        lm_sequential_phases(plan.n_stages, recovery=recovery),
        params=params, sils=sils, gen=_gen(gen) if sils is None else None)


def run_lm_parallel(cfg, plan, params, batch_fn, spec: TrainSpec,
                    gen: Optional[torch.Generator] = None, *, sils=None,
                    dist=None, dist_devices=None, ckpt_dir=None,
                    ckpt_every: int = 0, device="cuda",
                    tracer: Optional[Tracer] = None):
    """Fig. 5 at transformer scale over a PartitionPlan (``plan`` may be an
    int): stage 0 on ``batch_fn(i)``, stage k > 0 on SIL_{k-1}[:, y], each
    for its ``spec.stages`` steps.  The SIL tables come from ``gen``
    (class-major) unless ``sils`` are given.  ``dist`` / ``dist_devices``
    place each stage on its device through the stage executor, and
    ``ckpt_dir`` / ``ckpt_every`` checkpoint each stage on its own; then
    ``batch_fn`` must be a pure function of the step (a resumed stage
    replays the batches the others saw).  Returns (joined params,
    History)."""
    plan = resolve_plan(cfg, plan)
    backend = LMBackend(cfg, plan, batch_fn, spec, device=device)
    return Trainer(backend, spec, tracer=tracer).run(
        fig5_phases(dist=dist, dist_devices=dist_devices, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every),
        params=params, sils=sils, gen=_gen(gen) if sils is None else None)
