"""Model partitioning for PNN (paper §2, Figures 2-4), counterpart of
``repro/core/partition.py``.

A ``PartitionPlan`` cuts a transformer's group stack into ``n_stages``
contiguous stages.  Stage 0 owns the embedding (and an encoder-decoder's
encoder and decoder positions, or a vision config's ``img_proj``); the last
stage owns the final norm and the unembedding.  Boundaries are
residual-stream activations (width d_model); an encoder-decoder's carry the
encoder output too, as ``(x, enc_out)``.

The port's ``params["groups"]`` is a list of per-group dicts, so a stage's
groups are a slice of that list and joining concatenates the lists.  Slicing
shares the caller's tensors; the backend copies a stage before training it
in place (``LMBackend.split``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


@dataclass(frozen=True)
class PartitionPlan:
    n_stages: int
    bounds: Tuple[Tuple[int, int], ...]  # group ranges [g0, g1) per stage

    @property
    def cuts(self) -> int:
        return self.n_stages - 1


def make_plan(cfg: ModelConfig, n_stages: int, strategy: str = "uniform",
              **search_kw) -> PartitionPlan:
    """Cut the group stack into ``n_stages`` contiguous stages.

    strategy="uniform" (default) is the balanced contiguous divmod split;
    strategy="auto" routes through the ``repro_torch.plan`` cost-model
    searcher (``search_kw`` -- batch/seq/optimizer/objective -- feeds its
    cost table)."""
    g = M.n_groups(cfg)
    if n_stages > g:
        raise ValueError(f"{n_stages} stages > {g} groups for {cfg.name}")
    if strategy == "auto":
        # lazy import: repro_torch.plan imports PartitionPlan from here
        from repro_torch import plan as plan_lib
        return plan_lib.auto_plan(cfg, n_stages, **search_kw)
    if strategy != "uniform":
        raise ValueError(f"unknown partition strategy {strategy!r}; "
                         "expected 'uniform' or 'auto'")
    base, rem = divmod(g, n_stages)
    bounds, start = [], 0
    for k in range(n_stages):
        size = base + (1 if k < rem else 0)
        bounds.append((start, start + size))
        start += size
    return PartitionPlan(n_stages, tuple(bounds))


def stage_param_keys(cfg: ModelConfig, plan: PartitionPlan,
                     k: int) -> List[str]:
    keys = ["groups"]
    if k == 0:
        keys.append("tok_embed")
        if cfg.enc_dec:
            keys += ["encoder", "enc_norm", "dec_pos"]
        if cfg.frontend == "vision":
            keys.append("img_proj")
    if k == plan.n_stages - 1:
        keys.append("final_norm")
        if not cfg.tie_embeddings:
            keys.append("unembed")
        elif "tok_embed" not in keys:
            # tied unembedding on a stage that does not own the embedding:
            # a frozen copy, so two stages never train two copies of one
            # tensor
            keys.append("tied_unembed")
    return keys


def slice_stage_params(cfg: ModelConfig, plan: PartitionPlan, params,
                       k: int) -> Dict[str, Any]:
    """Exactly the parameters stage k trains (each partition holds only its
    own params and optimizer state).  ``tied_unembed`` is a frozen snapshot
    of the embedding, not a trainable copy."""
    g0, g1 = plan.bounds[k]
    out: Dict[str, Any] = {}
    for key in stage_param_keys(cfg, plan, k):
        if key == "groups":
            out[key] = list(params["groups"][g0:g1])
        elif key == "encoder":
            out[key] = list(params["encoder"])
        elif key == "tied_unembed":
            out[key] = params["tok_embed"]
        else:
            out[key] = params[key]
    return out


def refresh_tied_unembed(cfg: ModelConfig, plan: PartitionPlan,
                         stage_params: List[Dict[str, Any]]) -> None:
    """Sync the last stage's frozen tied-unembedding snapshot with stage 0's
    (possibly already trained) embedding, before the last stage trains.  A
    clone, not an alias: the optimizers update stage 0's embedding in place
    during recovery, which must not move the frozen snapshot."""
    if plan.n_stages > 1 and cfg.tie_embeddings:
        last = stage_params[plan.n_stages - 1]
        if "tied_unembed" in last:
            last["tied_unembed"] = stage_params[0]["tok_embed"].detach() \
                .clone()


def join_stage_params(cfg: ModelConfig, plan: PartitionPlan,
                      stage_params: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The full param tree from per-stage trees.  Frozen ``tied_unembed``
    snapshots are dropped: the joined network's tied unembedding is stage
    0's trained embedding."""
    full: Dict[str, Any] = {"groups": [g for sp in stage_params
                                       for g in sp["groups"]]}
    for sp in stage_params:
        for key, val in sp.items():
            if key not in ("groups", "tied_unembed"):
                full[key] = val
    return full


def stage_forward(cfg: ModelConfig, plan: PartitionPlan, k: int,
                  stage_params, batch_or_x, *, remat=True):
    """Forward of stage k alone.  Stage 0 consumes the batch (a dict with
    ``tokens``, and ``frames`` for an encoder-decoder or ``image_embeds``
    for a vision config); later stages consume the boundary activation (B,
    S, d), or an encoder-decoder's payload ``(x, enc_out)``.  Returns
    (output, aux): the boundary activation (the payload, for an
    encoder-decoder) for an interior stage, logits for the last;
    ``aux["n_prefix"]`` counts the image rows stage 0 prepended (0 on a
    later stage, as the reference's)."""
    g0, g1 = plan.bounds[k]
    n_prefix, enc_out = 0, None
    if k == 0:
        x, enc_out, n_prefix = M.embed_inputs(cfg, stage_params, batch_or_x)
    elif cfg.enc_dec:
        x, enc_out = batch_or_x
    else:
        x = batch_or_x
    rope_cs = M.rope_for(cfg, torch.arange(x.shape[1], device=x.device))
    x, aux, _ = M.forward_groups(cfg, stage_params["groups"], x,
                                 rope_cs=rope_cs, enc_out=enc_out, g0=0,
                                 g1=g1 - g0, remat=remat)
    aux["n_prefix"] = n_prefix
    if k == plan.n_stages - 1:
        x = M.norm_apply_final(cfg, stage_params, x)
        if "tied_unembed" in stage_params:
            # the frozen snapshot of the embedding: no gradient reaches it
            up = dict(stage_params)
            up["tok_embed"] = up.pop("tied_unembed").detach()
            return M.unembed(cfg, up, x), aux
        return M.unembed(cfg, stage_params, x), aux
    if cfg.enc_dec:
        return (x, enc_out), aux
    return x, aux
