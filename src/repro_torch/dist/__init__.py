"""``repro_torch.dist`` -- device-placed stage execution (counterpart of
``repro.dist``).

The paper's central claim (Fig. 5) is that SIL-decoupled stages train
*simultaneously on separate devices with no communication between them*.
``repro_torch.train.ParallelSilPhase(plan=...)`` runs that schedule through
this package:

* ``placement`` -- ``PlacementPlan`` maps stages onto devices
                   (``round_robin``, ``explicit``, ``memory_balanced``).
* ``executor``  -- ``StageExecutor`` pins each stage's params, optimizer
                   state and SIL tables to its device once, then launches
                   every stage's step per tick with no host sync; losses
                   are read once, at ``finalize``.
* ``lifecycle`` -- per-stage checkpoint / resume / join on
                   ``repro_torch.checkpoint``: one manifest and tick
                   counter per stage.

Entry points: ``ParallelSilPhase(plan=...)``, ``recipes.run_mlp_fig5`` /
``run_lm_parallel(dist=...)``, and ``launch/train.py --mode pnn --dist
round_robin``.  The reference's ``bench`` (one device against eight forced
host devices) is not ported (ROADMAP queue A, operations).
"""
from repro_torch.dist.executor import StageExecutor  # noqa: F401
from repro_torch.dist.lifecycle import (join_from_checkpoints,  # noqa: F401
                                        load_stage_params, restore_stage,
                                        save_stage, stage_dir, stage_ticks)
from repro_torch.dist.placement import (PlacementPlan,  # noqa: F401
                                        estimate_stage_bytes, explicit,
                                        memory_balanced, resolve,
                                        round_robin, stage_devices)

__all__ = [
    "StageExecutor",
    "PlacementPlan", "round_robin", "explicit", "memory_balanced",
    "resolve", "estimate_stage_bytes", "stage_devices",
    "save_stage", "restore_stage", "load_stage_params",
    "join_from_checkpoints", "stage_dir", "stage_ticks",
]
