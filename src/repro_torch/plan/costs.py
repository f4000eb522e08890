"""The unified per-stage cost model behind the auto-partitioner
(counterpart of ``repro/plan/costs.py``).

One place answers "what does stage [lo, hi) cost" for both backends:

* **resident bytes** -- params (storage dtype) + fp32 optimizer slots
  (``OPT_SLOTS[optimizer]`` per trainable element; the frozen
  ``tied_unembed`` snapshot counts param bytes but never slots) +
  activation stream + boundary spill, all dtype-aware.
  ``dist/placement.py``'s ``memory`` strategy packs stages by the same
  byte model (``estimate_stage_bytes``).
* **FLOPs** -- 6ND training napkin math per unit, attention-score terms for
  attention slots, plus the unembedding's product on the last stage.

A *unit* is the searcher's atom: one layer for the MLP backend, one
parameter group for the transformer backend (groups are the smallest
repeating block pattern, so every unit of a model costs the same -- the
non-uniformity the searcher exploits comes from the stage-0 embedding /
encoder / frontend overhead and the last stage's final norm and
unembedding).  The LM table reads the tree's shapes from
``init_params(cfg, gen, device="meta")``: no memory, no values.
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
    """Bytes of a tree of tensors from shapes and dtypes alone (meta
    tensors too).  ``itemsize`` overrides each leaf's width (4 sizes fp32
    optimizer slots over half-precision params)."""
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
    """Per-unit cost table + head/tail stage overheads for one model.

    ``stage_cost(lo, hi, k, n_stages)`` is O(1) via prefix sums, which is
    what keeps the bottleneck DP at O(n^2 K) overall."""
    kind: str                              # "mlp" | "lm"
    n_units: int
    optimizer: str
    # per-unit terms (len n_units each)
    unit_param_bytes: Tuple[int, ...]      # storage-dtype weight bytes
    unit_param_elems: Tuple[int, ...]      # trainable elements (slot sizing)
    unit_act_bytes: Tuple[int, ...]        # saved activations inside the unit
    unit_flops: Tuple[float, ...]
    unit_boundary_bytes: Tuple[int, ...]   # spill if the cut lands after unit
    # stage-0 overhead (embedding / encoder / frontend)
    head_param_bytes: int = 0
    head_param_elems: int = 0
    head_flops: float = 0.0
    # last-stage overhead (final norm + unembedding)
    tail_param_bytes: int = 0
    tail_param_elems: int = 0              # trainable tail elements
    tail_frozen_bytes: int = 0             # tied_unembed snapshot: no slots
    tail_flops: float = 0.0

    def __post_init__(self):
        for f in ("unit_param_bytes", "unit_param_elems", "unit_act_bytes",
                  "unit_flops", "unit_boundary_bytes"):
            if len(getattr(self, f)) != self.n_units:
                raise ValueError(f"{f} has {len(getattr(self, f))} entries "
                                 f"for {self.n_units} units")
        object.__setattr__(self, "_pb", _prefix(self.unit_param_bytes))
        object.__setattr__(self, "_pe", _prefix(self.unit_param_elems))
        object.__setattr__(self, "_ab", _prefix(self.unit_act_bytes))
        object.__setattr__(self, "_fl", _prefix(self.unit_flops))

    @property
    def slots(self) -> int:
        return opt_slots(self.optimizer)

    def stage_cost(self, lo: int, hi: int, k: int, n_stages: int
                   ) -> StageCost:
        if not 0 <= lo < hi <= self.n_units:
            raise ValueError(f"bad stage range [{lo}, {hi}) over "
                             f"{self.n_units} units")
        first, last = k == 0, k == n_stages - 1
        pb = self._pb[hi] - self._pb[lo]
        pe = self._pe[hi] - self._pe[lo]
        ab = self._ab[hi] - self._ab[lo]
        fl = self._fl[hi] - self._fl[lo]
        frozen = 0
        if first:
            pb += self.head_param_bytes
            pe += self.head_param_elems
            fl += self.head_flops
        if last:
            pb += self.tail_param_bytes
            pe += self.tail_param_elems
            frozen = self.tail_frozen_bytes
            fl += self.tail_flops
        bb = 0 if last else self.unit_boundary_bytes[hi - 1]
        return StageCost(stage=k, lo=lo, hi=hi,
                         params_bytes=pb + frozen,
                         opt_bytes=self.slots * pe * 4,
                         act_bytes=ab, boundary_bytes=bb, flops=fl)

    def stage_costs(self, bounds: Sequence[Tuple[int, int]]
                    ) -> List[StageCost]:
        n = len(bounds)
        return [self.stage_cost(lo, hi, k, n)
                for k, (lo, hi) in enumerate(bounds)]


def predicted_imbalance(stage_costs: Sequence[StageCost]) -> float:
    """max stage bytes / mean stage bytes (1.0 = perfectly balanced)."""
    sizes = [c.bytes_total for c in stage_costs]
    mean = sum(sizes) / len(sizes)
    return max(sizes) / mean if mean else 1.0


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
        kind="mlp", n_units=n, optimizer=optimizer,
        unit_param_bytes=tuple(e * 4 for e in elems),
        unit_param_elems=tuple(elems),
        unit_act_bytes=tuple(batch_size * cfg.sizes[i + 1] * it
                             for i in range(n)),
        unit_flops=tuple(6.0 * batch_size * cfg.sizes[i] * cfg.sizes[i + 1]
                         for i in range(n)),
        unit_boundary_bytes=tuple(batch_size * cfg.sizes[i + 1] * it
                                  for i in range(n)))


def lm_costs(cfg, *, batch: int = 8, seq: int = 512,
             optimizer: str = "adamw") -> ModelCosts:
    """Cost table for a transformer config: one unit per parameter group.

    Group weight bytes come from the real ``init_params`` tree on the meta
    device (dtype-aware), divided by the group count: every group has the
    same slots, so per-group cost is uniform by construction.  Head/tail
    overheads carry the non-uniformity:

    * head (stage 0): token embedding (+ encoder, enc_norm, dec_pos for
      enc-dec archs; + img_proj for vision) -- trainable.
    * tail (last stage): final norm, plus either the trainable ``unembed``
      or -- for tied embeddings -- the frozen ``tied_unembed`` snapshot,
      which costs param bytes but zero optimizer slots (LMBackend excludes
      it from the trainable tree).

    FLOPs are the reference's (6ND train + halved causal attention-score
    terms x3 for forward and backward + the unembedding's product), over
    ``cfg.param_counts()``, distributed over the units that own them."""
    from repro_torch.models import model as M

    struct = M.init_params(cfg, torch.Generator(), device="meta")
    g = M.n_groups(cfg)
    tokens = batch * seq
    it = dtype_itemsize(cfg.dtype)

    def bytes_elems(tree):
        b = e = 0
        for leaf in tree_leaves(tree):
            b += leaf.numel() * leaf.element_size()
            e += leaf.numel()
        return b, e

    gb, ge = bytes_elems(struct["groups"])
    group_bytes, group_elems = gb // g, ge // g

    head_keys = ["tok_embed"]
    if cfg.enc_dec:
        head_keys += ["encoder", "enc_norm", "dec_pos"]
    if cfg.frontend == "vision":
        head_keys.append("img_proj")
    hb = he = 0
    for k in head_keys:
        if k in struct:
            b, e = bytes_elems(struct[k])
            hb, he = hb + b, he + e

    tb, te = bytes_elems(struct["final_norm"])
    frozen_bytes = 0
    if cfg.tie_embeddings:
        frozen_bytes, _ = bytes_elems(struct["tok_embed"])
    elif "unembed" in struct:
        b, e = bytes_elems(struct["unembed"])
        tb, te = tb + b, te + e

    # FLOPs: 6 * tokens * active matmul params, split evenly over groups
    # (groups are homogeneous); attention-score terms per attention layer
    pc = cfg.param_counts()
    active_mat = pc["active"] - pc["embed"]
    enc_flops = 0.0
    if cfg.enc_dec:
        d, ff = cfg.d_model, cfg.d_ff
        hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        per_attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        if cfg.qkv_bias:
            per_attn += (H + 2 * KV) * hd
        enc_params = cfg.enc_layers * (per_attn + 2 * d * ff)
        active_mat -= enc_params          # the encoder lives on stage 0
        enc_tokens = batch * (cfg.enc_seq or seq)
        enc_flops = 6.0 * enc_params * enc_tokens \
            + 3.0 * cfg.enc_layers * (2.0 * batch * cfg.n_heads
                                      * (cfg.enc_seq or seq) ** 2
                                      * cfg.hd * 2)
    gsize = M.group_size(cfg)
    attn_per_group = sum(1 for l in range(gsize)  # noqa: E741
                         if cfg.block_kind(l) == "attn")
    span = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    attn_flops = 3.0 * attn_per_group \
        * (2.0 * batch * cfg.n_heads * seq * span * cfg.hd * 2) * 0.5
    group_flops = 6.0 * (active_mat / g) * tokens + attn_flops
    tail_flops = 6.0 * tokens * cfg.d_model * cfg.vocab_padded

    bb = tokens * cfg.d_model * it          # residual-stream spill at a cut
    if cfg.enc_dec:
        # the boundary payload carries the encoder output too
        bb += batch * (cfg.enc_seq or seq) * cfg.d_model * it
    act = gsize * tokens * cfg.d_model * it  # one residual save per layer

    return ModelCosts(
        kind="lm", n_units=g, optimizer=optimizer,
        unit_param_bytes=(group_bytes,) * g,
        unit_param_elems=(group_elems,) * g,
        unit_act_bytes=(act,) * g,
        unit_flops=(group_flops,) * g,
        unit_boundary_bytes=(bb,) * g,
        head_param_bytes=hb, head_param_elems=he, head_flops=enc_flops,
        tail_param_bytes=tb, tail_param_elems=te,
        tail_frozen_bytes=frozen_bytes, tail_flops=tail_flops,
    )


def costs_for(cfg, **kw) -> ModelCosts:
    """Dispatch on config type: MLPConfig -> mlp_costs, else lm_costs."""
    from repro_torch.models.mlp import MLPConfig
    if isinstance(cfg, MLPConfig):
        for drop in ("batch", "seq"):
            kw.pop(drop, None)
        return mlp_costs(cfg, **kw)
    for drop in ("batch_size", "compute_dtype"):
        kw.pop(drop, None)
    return lm_costs(cfg, **kw)
