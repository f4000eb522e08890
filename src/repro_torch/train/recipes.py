"""The paper's training procedures as phase lists (counterpart of the MLP
half of ``repro/train/recipes.py``):

    baseline   [BaselinePhase()]
    Fig. 3     [SilStagePhase(0), BoundaryMaterializePhase(1),
                FrozenPrefixPhase(1), RecoveryPhase(0)]

``run_mlp_baseline`` and ``run_mlp_fig3`` draw the params (then the SIL
table) from a ``torch.Generator``, or take them as ``params=`` / ``sil=``:
torch cannot reproduce the reference's threefry key schedule, so the
conformance tests pass the reference's arrays across
(``repro_torch.convert``).  They run on the card unless ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from repro_torch.core import sil as sil_lib
from repro_torch.models import mlp as MLP
from repro_torch.obs.trace import Tracer
from repro_torch.train.backends import MLPBackend
from repro_torch.train.phases import (BaselinePhase, BoundaryMaterializePhase,
                                      FrozenPrefixPhase, RecoveryPhase,
                                      SilStagePhase)
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
