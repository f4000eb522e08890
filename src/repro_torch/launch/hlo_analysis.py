"""Analytic roofline terms and per-chip byte accounting (counterpart of the
analytic half of ``repro/launch/hlo_analysis.py``).

* ``analytic_flops_per_chip`` / ``analytic_hbm_bytes_per_chip`` /
  ``analytic_peak_bytes_per_chip`` — workload napkin math: matmul FLOPs
  from the parameter counts (6ND train / 2ND inference), attention-score
  FLOPs (causal/windowed), an HBM traffic model (params + optimizer +
  activation/cache streams) and a residency model for the fit check.
* ``dtype_byte_breakdown`` / ``tree_bytes_per_chip`` — bytes of a tree of
  (meta) tensors, per chip under ``launch/sharding.py``'s specs.

The reference's other half reads XLA's compiled HLO text (collective bytes
with while-loop trip counts, ``collective_stats_loop_aware`` and its
parsers).  The port compiles no whole program, so that half has no
counterpart.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.sharding import leaves_with_paths
from repro_torch.plan.costs import dtype_itemsize


# --------------------------------------------------------------------------
# tree byte accounting (shared by dryrun and the chip's fit check)
# --------------------------------------------------------------------------

def dtype_name(dtype) -> str:
    """A dtype's name as the reference keys it ("bfloat16", "float32",
    "int32", ...), for a torch dtype or a name."""
    return str(dtype).removeprefix("torch.")


def dtype_byte_breakdown(tree, specs=None, mesh=None) -> Dict[str, int]:
    """Per-dtype byte totals of a tree (dicts and lists) of tensors, meta
    tensors too.

    With ``specs`` (a matching tree of ``launch/sharding.py`` specs) and
    ``mesh``, each leaf is divided by the product of its sharded mesh-axis
    sizes — per-chip bytes.  The leaves of a list split over an axis
    (``LeafSpec``s with a ``lead``) are summed, then divided by the lead's
    axis size, as the reference divides its stacked leaf.  Without specs,
    global bytes."""
    leaves = [t for _, t in leaves_with_paths(tree)]
    shards = [s for _, s in leaves_with_paths(specs)] if specs is not None \
        else [None] * len(leaves)
    assert len(shards) == len(leaves), (len(shards), len(leaves))
    out: Dict[str, int] = {}
    split: Dict[tuple, int] = {}
    for leaf, sh in zip(leaves, shards):
        den = 1
        for ent in sh or ():
            if ent is None:
                continue
            for ax in (ent if isinstance(ent, tuple) else (ent,)):
                den *= mesh.shape[ax]
        dt = dtype_name(leaf.dtype)
        b = (leaf.numel() // max(den, 1)) * leaf.element_size()
        lead = getattr(sh, "lead", None)
        if lead is None:
            out[dt] = out.get(dt, 0) + b
        else:
            split[dt, lead] = split.get((dt, lead), 0) + b
    for (dt, lead), b in split.items():
        out[dt] = out.get(dt, 0) + b // mesh.shape[lead]
    return out


def tree_bytes_per_chip(tree, specs=None, mesh=None) -> int:
    """Total (per-chip, when sharded) bytes of a tree — the sum of
    ``dtype_byte_breakdown``."""
    return sum(dtype_byte_breakdown(tree, specs, mesh).values())


# --------------------------------------------------------------------------
# analytic workload model
# --------------------------------------------------------------------------

def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for l in range(cfg.n_layers) if cfg.block_kind(l) == "attn")


def analytic_flops_per_chip(cfg: ModelConfig, shape: InputShape,
                            n_chips: int) -> float:
    """Matmul + attention-score FLOPs for one step, per chip."""
    pc = cfg.param_counts()
    n_mat = pc["active"] - pc["embed"]
    b, s = shape.global_batch, shape.seq_len
    h, hd = cfg.n_heads, cfg.hd
    la = _attn_layers(cfg)
    w = cfg.sliding_window
    if shape.kind == "train":
        tokens = b * s
        mat = 6.0 * n_mat * tokens
        # causal scores: 2*B*H*S^2*hd (QK) + same (PV), halved for causality,
        # x3 for fwd+bwd
        span = min(s, w) if w else s
        attn = 3.0 * la * (2.0 * b * h * s * span * hd * 2) * 0.5
        # unembed matmul (padded vocab)
        mat += 6.0 * tokens * cfg.d_model * cfg.vocab_padded
    elif shape.kind == "prefill":
        tokens = b * s
        mat = 2.0 * n_mat * tokens
        span = min(s, w) if w else s
        attn = la * (2.0 * b * h * s * span * hd * 2) * 0.5
        mat += 2.0 * b * cfg.d_model * cfg.vocab_padded  # last-token logits
    else:  # decode
        mat = 2.0 * n_mat * b
        lc = min(s, w) if w else s
        attn = la * (2.0 * b * h * lc * hd * 2)
        mat += 2.0 * b * cfg.d_model * cfg.vocab_padded
    return (mat + attn) / n_chips


def analytic_hbm_bytes_per_chip(cfg: ModelConfig, shape: InputShape,
                                n_chips: int, *, params_bytes_per_chip: int,
                                opt_bytes_per_chip: int = 0,
                                cache_bytes_per_chip: int = 0,
                                accum: int = 1) -> float:
    """HBM traffic model for one step, per chip.

    train:   fwd reads params (x accum microbatches under FSDP gathering the
             same shards), bwd reads again, optimizer reads+writes params and
             state; activation stream ~ 2 x (saved boundaries rw).
    prefill: params once, cache written once, activation stream.
    decode:  params once, cache read+written.
    """
    # activation-stream element size follows the precision policy's
    # compute dtype (bf16/fp16 halve it), not a hard-coded constant
    dt = dtype_itemsize(cfg.dtype)
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    g_boundaries = cfg.n_layers  # one residual save per layer (remat policy)
    if shape.kind == "train":
        tokens_per_chip = b * s / n_chips
        act = 4.0 * tokens_per_chip * d * dt * g_boundaries  # save+reread,f+b
        logits = 2.0 * tokens_per_chip * cfg.vocab_padded * 4
        pbytes = params_bytes_per_chip * (2.0 * accum + 2.0)
        obytes = 2.0 * opt_bytes_per_chip
        return pbytes + obytes + act + logits
    if shape.kind == "prefill":
        tokens_per_chip = b * s / n_chips
        act = 2.0 * tokens_per_chip * d * dt * g_boundaries
        return params_bytes_per_chip + cache_bytes_per_chip + act
    # decode
    return params_bytes_per_chip + 2.0 * cache_bytes_per_chip \
        + 2.0 * (b / max(n_chips, 1)) * d * dt * g_boundaries


def analytic_peak_bytes_per_chip(cfg: ModelConfig, shape: InputShape,
                                 n_chips: int, *, params_bytes_per_chip: int,
                                 opt_bytes_per_chip: int = 0,
                                 cache_bytes_per_chip: int = 0,
                                 accum: int = 1) -> float:
    """HBM-residency estimate for the fit check, the steady state: params
    + optimizer + grad accumulator + per-microbatch activation saves (one
    residual per layer under the remat policy) + logits + transient
    gathered layer weights.  Written for a TPU under XLA's buffer reuse;
    ``chip_smoke.py``'s dryrun phase holds it against the allocator's peak
    on one card."""
    # activation-stream element size follows the precision policy's
    # compute dtype (bf16/fp16 halve it), not a hard-coded constant
    dt = dtype_itemsize(cfg.dtype)
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if shape.kind == "train":
        # data shards only (model axis shards activations' hidden dims at
        # most; count unsharded = worst case)
        dp = min(b, 16 if n_chips >= 256 else n_chips)
        tokens_mb = (b // max(accum, 1)) * s / dp
        saves = tokens_mb * d * dt * cfg.n_layers
        logits = 2.0 * tokens_mb * cfg.vocab_padded * 4 / 16  # vocab sharded
        grads = params_bytes_per_chip * (2 if accum > 1 else 1)
        return (params_bytes_per_chip + opt_bytes_per_chip + grads
                + saves + logits)
    if shape.kind == "prefill":
        dp = min(b, 16 if n_chips >= 256 else n_chips)
        work = (b / dp) * s * d * dt * 4  # a few live layer tensors
        return params_bytes_per_chip + cache_bytes_per_chip + work
    return params_bytes_per_chip + cache_bytes_per_chip \
        + 0.1 * params_bytes_per_chip
