"""``repro_torch.plan`` -- the per-stage cost model (the part of
``repro.plan`` that stage placement and the paper-MLP CLI need; the
auto-partitioner's searcher is not ported yet)."""
from repro_torch.plan.costs import (OPT_SLOTS, ModelCosts, StageCost,
                                    estimate_stage_bytes, mlp_costs,
                                    opt_slots, tree_param_bytes)

__all__ = ["OPT_SLOTS", "ModelCosts", "StageCost", "estimate_stage_bytes",
           "mlp_costs", "opt_slots", "tree_param_bytes"]
