"""PartitionPlan-aware serving: prefill and decode over per-stage param trees
(counterpart of ``repro/serve/staged.py``).

The paper's partitions train independently and deploy independently: this
module serves straight from the per-stage trees
(``partition.slice_stage_params``, or ``stage_params_from_checkpoints``)
without joining them.  Stage 0 owns the embedding, the last stage the final
norm and the unembedding, which reads the last stage's frozen
``tied_unembed`` snapshot when the embeddings are tied.  A joined tree
unembeds with stage 0's embedding instead, so the two agree only where the
snapshot equals it (``partition.refresh_tied_unembed`` before deploying;
after §5 recovery has moved stage 0's embedding they differ, as in the
reference).

The caches keep the stacked (G, ...) layout of the whole model, so one
``CachePool`` serves both modes.  Decode writes in place: stage k gets
``leaf[g0:g1]``, a view of the pool's leaf, for the contiguous (G, B, Lc,
KV, hd) and the paged (G, NB, BS, KV, hd) K/V alike.  The prefill
concatenates the stages' stacked caches on the group axis, as the
reference does, before repacking them into cache slots.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.tree import tree_map


def stage_params_from_checkpoints(cfg, plan, ckpt_root, *, step=None,
                                  devices=None):
    """Per-stage param trees for staged serving, restored straight from a
    per-stage checkpoint directory (``repro_torch.dist.lifecycle``, the
    format the reference shares): the partitions deploy without ever being
    joined.

    The restore needs only the trees' structure, so the ``like`` trees are
    made on the ``meta`` device (no weights besides the checkpointed ones).
    ``devices`` lands stage k on ``devices[k]``; without it the trees are
    host tensors, which ``serve.Engine(cfg, plan=plan, stage_params=...)``
    puts on its device."""
    from repro_torch.core import partition
    from repro_torch.dist import lifecycle
    params = M.init_params(cfg, torch.Generator(), device="meta")
    likes = [partition.slice_stage_params(cfg, plan, params, k)
             for k in range(plan.n_stages)]
    return lifecycle.load_stage_params(ckpt_root, likes, step=step,
                                       devices=devices)


def _unembed_params(cfg, last_stage_params):
    """The last stage's params as ``M.unembed`` reads them: its frozen
    ``tied_unembed`` snapshot as ``tok_embed`` when the embeddings are
    tied."""
    if "tied_unembed" in last_stage_params:
        return {"tok_embed": last_stage_params["tied_unembed"]}
    return last_stage_params


def _stage_cache(plan, k, cache):
    """Stage k's groups of the stacked cache: views, written in place."""
    g0, g1 = plan.bounds[k]
    return tree_map(lambda a: a[g0:g1], cache)


def staged_prefill(cfg, plan, stage_params, batch, cache_len):
    """Prompt forward through the stage chain, building the decode cache.

    The contract of ``model.prefill``: (last-token logits (B, V), cache,
    next_pos); the cache is stacked over all groups (the stages' slices
    concatenated), so it drops into the shared pool.  An encoder-decoder's
    encoder runs with stage 0's embedding and its output reaches every
    stage's cross blocks."""
    x, enc_out, _ = M.embed_inputs(cfg, stage_params[0], batch)
    s = x.shape[1]
    rope_cs = M.rope_for(cfg, torch.arange(s, device=x.device))
    caches = []
    for k in range(plan.n_stages):
        x, _, c = M.forward_groups(cfg, stage_params[k]["groups"], x,
                                   rope_cs=rope_cs, enc_out=enc_out,
                                   collect_cache=True, remat=False)
        caches.append(c)
    full = {sk: {n: torch.cat([c[sk][n] for c in caches])
                 for n in caches[0][sk]}
            for sk in caches[0]}
    cache = M.repack_prefill_cache(cfg, full, cache_len)
    last = stage_params[-1]
    xl = L.norm_apply(last["final_norm"], x[:, -1:])
    logits = M.unembed(cfg, _unembed_params(cfg, last), xl)[:, 0]
    return logits, cache, s


def staged_decode_step(cfg, plan, stage_params, cache, tok, pos, paged=None):
    """One decode step through the stage chain, with the contract of
    ``model.decode_step`` (pos: int or (B,) tensor; ``paged``: one block
    table shared by every stage).  The cache is updated in place."""
    x, rope_cs = M.decode_embed(cfg, stage_params[0], tok, pos)
    for k in range(plan.n_stages):
        x, _ = M.decode_groups(cfg, stage_params[k]["groups"],
                               _stage_cache(plan, k, cache), x, rope_cs, pos,
                               paged=paged)
    last = stage_params[-1]
    x = L.norm_apply(last["final_norm"], x)
    return M.unembed(cfg, _unembed_params(cfg, last), x)[:, 0], cache
