"""``repro_torch.train`` -- the composable phase API for PNN training of the
paper's MLP (counterpart of ``repro.train``).

    from repro_torch.train import recipes
    spec = recipes.paper_spec(n_left=5, n_right=160)
    params, hist = recipes.run_mlp_fig3(cfg, data, spec, gen)
"""
from repro_torch.train import recipes
from repro_torch.train.backends import MLPBackend
from repro_torch.train.boundary import BoundaryCache
from repro_torch.train.history import History
from repro_torch.train.phases import (BaselinePhase, BoundaryMaterializePhase,
                                      FrozenPrefixPhase, ParallelSilPhase,
                                      RecoveryPhase, SilStagePhase)
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.train.trainer import Trainer, TrainState

__all__ = [
    "recipes", "MLPBackend", "BoundaryCache", "History",
    "BaselinePhase", "BoundaryMaterializePhase", "FrozenPrefixPhase",
    "ParallelSilPhase", "RecoveryPhase", "SilStagePhase",
    "StageSpec", "TrainSpec", "Trainer", "TrainState",
]
