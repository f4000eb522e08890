"""``repro_torch.plan`` -- the cost-model-driven auto-partitioner
(counterpart of ``repro.plan``).

The paper hand-picks one 6-layer/2-stage split; this subsystem searches
stage boundaries for every arch instead.  Module map:

* ``costs``  -- the unified per-stage cost model (params + optimizer slots
  + activation/boundary bytes, FLOPs; dtype-aware), shared with
  ``dist/placement``'s byte estimate.
* ``search`` -- bottleneck DP over the cost table (head/tail-overhead-aware
  chains-on-chains), deterministic uniform tie-break, rejected-frontier
  enumeration.

Entry points (this module):

* ``auto_plan(cfg, n_stages)``      -> searched ``PartitionPlan`` (LM)
* ``auto_mlp_bounds(cfg, n_stages)``-> searched layer bounds (MLP)
* ``plan_report(cfg, n_stages)``    -> the PLAN_7.json per-arch record
* ``parse_stages("auto:4")``        -> ("auto", 4) -- the CLI surface

Wired end to end: ``core/partition.make_plan(..., strategy="auto")``,
``train/backends.balanced_bounds(..., costs=...)``,
``train/recipes.resolve_plan("auto[:K]")``, ``--stages auto[:K]`` on
``launch/train.py``, and the ``launch/plan`` CLI that writes
``results/PLAN_7.json``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

from repro_torch.plan.costs import (OPT_SLOTS, ModelCosts, StageCost,
                                    costs_for, estimate_stage_bytes,
                                    lm_costs, mlp_costs, opt_slots,
                                    predicted_imbalance, tree_param_bytes)
from repro_torch.plan.search import (Bounds, brute_force_bounds, frontier,
                                     search_report, solve, uniform_bounds)

__all__ = [
    "ModelCosts", "OPT_SLOTS", "StageCost", "costs_for",
    "estimate_stage_bytes", "lm_costs", "mlp_costs", "opt_slots",
    "predicted_imbalance", "tree_param_bytes",
    "Bounds", "brute_force_bounds", "frontier", "search_report", "solve",
    "uniform_bounds",
    "DEFAULT_BATCH", "DEFAULT_SEQ",
    "auto_bounds", "auto_mlp_bounds", "auto_plan", "parse_stages",
    "plan_report",
]

# the workload the default LM cost tables assume (overridable everywhere);
# small enough that byte terms stay param-dominated, matching how SIL
# stages actually train (per-stage batches, not the 4k-seq pretrain shape)
DEFAULT_BATCH = 8
DEFAULT_SEQ = 512


def auto_bounds(costs: ModelCosts, n_stages: int, *,
                objective: str = "bytes") -> Bounds:
    """Searched bounds over a prebuilt cost table."""
    return solve(costs, n_stages, objective=objective)


def auto_plan(cfg, n_stages: int, *, batch: int = DEFAULT_BATCH,
              seq: int = DEFAULT_SEQ, optimizer: str = "adamw",
              objective: str = "bytes"):
    """Searched ``PartitionPlan`` for a transformer config."""
    from repro_torch.core.partition import PartitionPlan
    table = lm_costs(cfg, batch=batch, seq=seq, optimizer=optimizer)
    return PartitionPlan(n_stages, solve(table, n_stages,
                                         objective=objective))


def auto_mlp_bounds(cfg, n_stages: int, *, batch_size: int = 1410,
                    optimizer: str = "sgdm", compute_dtype: str = "float32",
                    objective: str = "bytes") -> Bounds:
    """Searched layer bounds for the MLP backend."""
    table = mlp_costs(cfg, batch_size=batch_size, optimizer=optimizer,
                      compute_dtype=compute_dtype)
    return solve(table, n_stages, objective=objective)


def plan_report(cfg, n_stages: int, *, batch: Optional[int] = None,
                seq: int = DEFAULT_SEQ, optimizer: Optional[str] = None,
                objective: str = "bytes") -> dict:
    """The per-arch PLAN_7 record (see ``search.search_report``)."""
    from repro_torch.models.mlp import MLPConfig
    if isinstance(cfg, MLPConfig):
        table = mlp_costs(cfg, batch_size=batch or 1410,
                          optimizer=optimizer or "sgdm")
        arch_row = {"arch": cfg.name, "kind": "mlp",
                    "batch_size": batch or 1410}
    else:
        table = lm_costs(cfg, batch=batch or DEFAULT_BATCH, seq=seq,
                         optimizer=optimizer or "adamw")
        arch_row = {"arch": cfg.name, "kind": "lm",
                    "batch": batch or DEFAULT_BATCH, "seq": seq}
    rep = search_report(table, n_stages, objective=objective)
    rep.update(arch_row)
    return rep


def parse_stages(value: Union[str, int], *, default_k: int = 2
                 ) -> Tuple[str, int]:
    """CLI ``--stages`` surface: ``"3"`` -> ("uniform", 3), ``"auto"`` ->
    ("auto", default_k), ``"auto:4"`` -> ("auto", 4)."""
    if isinstance(value, int):
        return "uniform", value
    s = value.strip().lower()
    if s.startswith("auto"):
        rest = s[4:]
        if not rest:
            return "auto", default_k
        if rest.startswith(":") and rest[1:].isdigit():
            return "auto", int(rest[1:])
        raise ValueError(f"bad --stages value {value!r}; expected N, "
                         "'auto', or 'auto:K'")
    if s.isdigit():
        return "uniform", int(s)
    raise ValueError(f"bad --stages value {value!r}; expected N, 'auto', "
                     "or 'auto:K'")
