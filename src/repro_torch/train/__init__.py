"""``repro_torch.train`` -- the composable phase API for PNN training of the
paper's MLP and of the transformer stacks (counterpart of ``repro.train``).

    from repro_torch.train import recipes
    spec = recipes.paper_spec(n_left=5, n_right=160)
    params, hist = recipes.run_mlp_fig3(cfg, data, spec, gen)

The LM's Fig. 3 is the reference's composition over an ``LMBackend``:

    Trainer(backend, spec).run(
        [SilStagePhase(0), BoundaryMaterializePhase(upto=1, n_batches=8),
         FrozenPrefixPhase(1, source="cache"), RecoveryPhase(0)],
        params=params, gen=gen)
"""
from repro_torch.train import recipes
from repro_torch.train.backends import LMBackend, MLPBackend
from repro_torch.train.boundary import BoundaryCache
from repro_torch.train.history import History
from repro_torch.train.phases import (BaselinePhase, BoundaryMaterializePhase,
                                      FrozenPrefixPhase, ParallelSilPhase,
                                      RecoveryPhase, SilStagePhase)
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.train.trainer import Trainer, TrainState

__all__ = [
    "recipes", "LMBackend", "MLPBackend", "BoundaryCache", "History",
    "BaselinePhase", "BoundaryMaterializePhase", "FrozenPrefixPhase",
    "ParallelSilPhase", "RecoveryPhase", "SilStagePhase",
    "StageSpec", "TrainSpec", "Trainer", "TrainState",
]
