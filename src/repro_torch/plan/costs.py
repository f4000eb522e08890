"""The per-stage byte model that stage placement reads, and the paper MLP's
cost table (the part of ``repro/plan/costs.py`` the port needs so far).

* **resident bytes** of a live stage: params (storage dtype) + fp32
  optimizer slots (``OPT_SLOTS[optimizer]`` per trainable element); the
  frozen ``tied_unembed`` snapshot counts param bytes but never slots.
  ``dist/placement.py``'s ``memory`` strategy packs stages by it.
* ``mlp_costs``: the paper MLP's table, one unit per layer (params,
  optimizer slots, activation and boundary bytes, training FLOPs), whose
  ``stage_costs(bounds)`` rows the paper-MLP CLI prints.

The LM cost table (``lm_costs``) and the boundary searcher
(``plan/search.py``) are not ported yet (ROADMAP queue A, operations).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.tree import tree_leaves

# optimizer-state slots per trainable param (fp32 each).  adafactor's
# factored second moments are ~sqrt-sized: negligible here.
OPT_SLOTS = {"sgd": 0, "sgdm": 1, "adam": 2, "adamw": 2, "adafactor": 0}


def opt_slots(optimizer: str) -> int:
    """fp32 slots per trainable element; unknown optimizers assume 2."""
    return OPT_SLOTS.get(optimizer, 2)


def dtype_itemsize(dtype) -> int:
    """Bytes per element of a dtype given as a string or a torch dtype."""
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def tree_param_bytes(tree, itemsize: Optional[int] = None) -> int:
    """Bytes of a tree of tensors from shapes and dtypes alone.
    ``itemsize`` overrides each leaf's width (4 sizes fp32 optimizer slots
    over half-precision params)."""
    total = 0
    for leaf in tree_leaves(tree):
        total += leaf.numel() * (itemsize if itemsize is not None
                                 else leaf.element_size())
    return total


def estimate_stage_bytes(stage_params, optimizer: str = "sgdm") -> int:
    """Resident bytes of one live training stage: params + fp32 optimizer
    slots (grads are transient and left out).  The frozen ``tied_unembed``
    snapshot gets param bytes but no slots: ``LMBackend`` never allocates
    optimizer state for it."""
    slots = opt_slots(optimizer)
    total = tree_param_bytes(stage_params)
    if isinstance(stage_params, dict):
        trainable = {k: v for k, v in stage_params.items()
                     if k != "tied_unembed"}
    else:
        trainable = stage_params
    return total + slots * tree_param_bytes(trainable, itemsize=4)


@dataclass(frozen=True)
class StageCost:
    """Predicted cost of one stage [lo, hi) in units."""
    stage: int
    lo: int
    hi: int
    params_bytes: int      # storage-dtype weights (incl. frozen snapshots)
    opt_bytes: int         # fp32 optimizer slots over trainable elements
    act_bytes: int         # activation stream saved across the stage
    boundary_bytes: int    # boundary spill emitted at the stage's cut
    flops: float

    @property
    def bytes_total(self) -> int:
        return (self.params_bytes + self.opt_bytes + self.act_bytes
                + self.boundary_bytes)

    def row(self) -> Dict[str, Any]:
        return {"stage": self.stage, "units": [self.lo, self.hi],
                "params_bytes": int(self.params_bytes),
                "opt_bytes": int(self.opt_bytes),
                "act_bytes": int(self.act_bytes),
                "boundary_bytes": int(self.boundary_bytes),
                "bytes_total": int(self.bytes_total),
                "flops": float(self.flops)}


def _prefix(xs) -> Tuple:
    out = [0]
    for x in xs:
        out.append(out[-1] + x)
    return tuple(out)


@dataclass(frozen=True)
class ModelCosts:
    """Per-unit cost table for one model; ``stage_cost(lo, hi, k,
    n_stages)`` sums units by prefix sums.  The MLP has no head or tail
    overhead (the reference's embedding and unembedding terms belong to
    the LM table, not ported)."""
    n_units: int
    optimizer: str
    unit_param_bytes: Tuple[int, ...]
    unit_param_elems: Tuple[int, ...]
    unit_act_bytes: Tuple[int, ...]
    unit_flops: Tuple[float, ...]
    unit_boundary_bytes: Tuple[int, ...]

    def __post_init__(self):
        for f in ("unit_param_bytes", "unit_param_elems", "unit_act_bytes",
                  "unit_flops", "unit_boundary_bytes"):
            if len(getattr(self, f)) != self.n_units:
                raise ValueError(f"{f} has {len(getattr(self, f))} entries "
                                 f"for {self.n_units} units")

    @property
    def slots(self) -> int:
        return opt_slots(self.optimizer)

    def stage_cost(self, lo: int, hi: int, k: int, n_stages: int
                   ) -> StageCost:
        if not 0 <= lo < hi <= self.n_units:
            raise ValueError(f"bad stage range [{lo}, {hi}) over "
                             f"{self.n_units} units")

        def span(xs):
            p = _prefix(xs)
            return p[hi] - p[lo]
        last = k == n_stages - 1
        return StageCost(
            stage=k, lo=lo, hi=hi,
            params_bytes=span(self.unit_param_bytes),
            opt_bytes=self.slots * span(self.unit_param_elems) * 4,
            act_bytes=span(self.unit_act_bytes),
            boundary_bytes=0 if last else self.unit_boundary_bytes[hi - 1],
            flops=span(self.unit_flops))

    def stage_costs(self, bounds: Sequence[Tuple[int, int]]
                    ) -> List[StageCost]:
        n = len(bounds)
        return [self.stage_cost(lo, hi, k, n)
                for k, (lo, hi) in enumerate(bounds)]


def mlp_costs(cfg, *, batch_size: int = 1410, optimizer: str = "sgdm",
              compute_dtype: str = "float32") -> ModelCosts:
    """Cost table for the paper's MLP: one unit per layer.  Weights are
    fp32 (the MLP backend's storage dtype); activations and the boundary
    spill follow ``compute_dtype``.  FLOPs use the paper's MAC counting x 6
    (forward + backward training) x batch."""
    it = dtype_itemsize(compute_dtype)
    n = cfg.n_layers
    elems = [cfg.sizes[i] * cfg.sizes[i + 1] + cfg.sizes[i + 1]
             for i in range(n)]
    return ModelCosts(
        n_units=n, optimizer=optimizer,
        unit_param_bytes=tuple(e * 4 for e in elems),
        unit_param_elems=tuple(elems),
        unit_act_bytes=tuple(batch_size * cfg.sizes[i + 1] * it
                             for i in range(n)),
        unit_flops=tuple(6.0 * batch_size * cfg.sizes[i] * cfg.sizes[i + 1]
                         for i in range(n)),
        unit_boundary_bytes=tuple(batch_size * cfg.sizes[i + 1] * it
                                  for i in range(n)))
