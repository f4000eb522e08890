"""Step builders: train / PNN stage / prefill / decode (counterpart of
``repro/launch/steps.py``).

``build_train_step`` is conventional end-to-end training of the
unpartitioned network — the paper's baseline — with gradient-accumulation
microbatching; ``build_pnn_stage_step`` one stage of the partitioned
scheme.  Both are the training backend's own builders
(``train.backends.build_train_step``, which the trainer's baseline phase
also runs, and ``stage_objective``): as everywhere in the port, the
optimizer updates the params and its state in place, and a step returns
the objects it was given.

The reference's sharding hooks need a mesh of cards, which the port does
not have: ``seq_shard_fn=`` and ``grad_pspecs=`` raise a ``ValueError``,
and ``pick_accum`` counts one data shard (ROADMAP queue A, step 5:
``launch/{sharding,mesh}.py`` as DeviceMesh/DTensor).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import precision as precision_lib
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M
from repro_torch.train import backends


def _refuse_mesh(seq_shard_fn=None, grad_pspecs=None, policy=None) -> None:
    for name, v in (("seq_shard_fn", seq_shard_fn),
                    ("grad_pspecs", grad_pspecs), ("policy", policy)):
        if v is not None:
            raise ValueError(
                f"{name}= shards over the production mesh, which the port "
                "does not have (ROADMAP queue A, step 5: "
                "launch/{sharding,mesh}.py as DeviceMesh/DTensor)")


def pick_optimizer_name(cfg: ModelConfig) -> str:
    """Memory-aware default: Adafactor for >=50B-param models."""
    return "adafactor" if cfg.param_counts()["total"] > 50e9 else "adamw"


def pick_accum(cfg: ModelConfig, shape: InputShape, policy=None) -> int:
    """Microbatch count: keep live activations bounded while never dropping
    below 1 sample per data shard.  The reference divides the batch by its
    mesh's data shards; the port has no mesh, so it counts one shard
    (``policy`` must be None)."""
    _refuse_mesh(policy=policy)
    total = cfg.param_counts()["total"]
    want = 16 if total > 20e9 else (8 if total > 5e9 else 1)
    return max(1, min(want, shape.global_batch))


def build_train_step(cfg: ModelConfig, opt, *, accum: int = 1,
                     seq_shard_fn=None,
                     accum_dtype: torch.dtype = torch.float32,
                     grad_pspecs=None):
    """``train.backends.build_train_step``: ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)``, ``metrics`` with ``loss``,
    ``ce`` (``lb``, ``z`` with experts) and ``grad_norm``."""
    _refuse_mesh(seq_shard_fn, grad_pspecs)
    return backends.build_train_step(cfg, opt, accum=accum,
                                     accum_dtype=accum_dtype)


def build_pnn_stage_step(cfg: ModelConfig, plan, k: int, opt, *,
                         seq_shard_fn=None, grad_pspecs=None):
    """PNN stage-k train step (the paper's scheme at scale):
    ``stage_step(stage_params, opt_state, xin, labels, sil) ->
    (stage_params, opt_state, loss)``.

    Stage 0 takes the raw batch dict, a later stage the boundary activation
    ``xin`` (B, S, d).  An interior stage trains with SIL-MSE on its
    boundary against ``sil`` (a (d, vocab) table) plus its MoE aux terms;
    the last with CE (``sil`` unused).  Every leaf of ``stage_params`` is
    differentiated; the last stage's frozen ``tied_unembed`` gets a zero
    gradient, as under the reference's stop-gradient."""
    _refuse_mesh(seq_shard_fn, grad_pspecs)
    precision_lib.policy_for(cfg).apply_backend_flags()

    def loss_fn(p, xin, labels, sil):
        return backends.stage_objective(cfg, plan, k, p, xin, labels, sil)

    def stage_step(stage_params, opt_state, xin, labels,
                   sil: Optional[torch.Tensor]):
        loss, grads = backends.value_and_accum_grads(
            loss_fn, stage_params, (xin, labels, sil))
        opt.update(grads, opt_state, stage_params)
        return stage_params, opt_state, loss

    return stage_step


def build_prefill_step(cfg: ModelConfig, cache_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, cache_len)
    return prefill_step


def build_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos)
    return serve_step
