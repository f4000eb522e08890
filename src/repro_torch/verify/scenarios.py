"""Shared tiny-config scenarios (counterpart of
``repro/verify/scenarios.py``).

One place for the hand-built mini worlds the conformance oracles need: a
reduced MLP training setup, a reduced PartitionPlan'd LM setup, a serving
world, and the one-request-at-a-time greedy decode reference.

Everything here is deterministic (fixed seeds, pure batch functions) so the
bitwise oracles stay bitwise.  Weights are drawn from ``torch.Generator``s
on the CPU and then placed on ``device``, so the card and the CPU start
from the same numbers; the data (``data.images.emnist_like``, the serving
prompts from ``np.random.RandomState``) is numpy and equals the reference's
bit for bit.  The reference's ``tiny_lm`` draws its token batches from
``jax.random.PRNGKey(1000 + i)``, which torch cannot reproduce: the port's
default ``batch_fn`` draws them from ``np.random.RandomState(1000 + i)``,
and a conformance test hands the reference's batches across as
``batch_fn``.  The functions that make tensors (``tiny_lm``,
``serve_params``, ``greedy_reference``) take a ``device``; the others return
configs and host data, which the backends and engines place themselves.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.data.images import emnist_like
from repro_torch.models import model as M
from repro_torch.models.mlp import MLPConfig
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.tree import tree_map


def _placed(tree, device):
    return tree_map(lambda t: t.to(device), tree)


# --------------------------------------------------------------------------
# MLP world (the paper's experiment, reduced)
# --------------------------------------------------------------------------

def tiny_mlp(n_stages: int = 3, epochs: Sequence[int] = (2, 2, 2), *,
             n_train: int = 1024, n_test: int = 128, batch_size: int = 128,
             lr: float = 0.01, kappa: float = 10.0, noise: float = 0.5,
             sizes: Optional[Tuple[int, ...]] = None,
             precision=None, baseline_epochs: Optional[int] = None,
             seed: int = 0):
    """(cfg, data, spec) for a fast paper-MLP experiment, the reference's
    values; ``sizes`` overrides the network (e.g. the smoke
    (784, 32, 16, 16, 47)).  ``data`` is numpy: ``MLPBackend(...,
    device=)`` puts it on the device once."""
    cfg = MLPConfig() if sizes is None else MLPConfig(sizes=sizes, cut=2)
    data = emnist_like(n_train=n_train, n_test=n_test, seed=seed, noise=noise)
    baseline = None if baseline_epochs is None else StageSpec(
        epochs=baseline_epochs, lr=lr, optimizer="sgdm")
    spec = TrainSpec(batch_size=batch_size, kappa=kappa, n_stages=n_stages,
                     precision=precision, baseline=baseline,
                     stages=tuple(StageSpec(epochs=e, lr=lr)
                                  for e in epochs))
    return cfg, data, spec


# --------------------------------------------------------------------------
# LM world (PartitionPlan over a smoke transformer)
# --------------------------------------------------------------------------

def lm_batch_fn(vocab: int, batch: int = 2, seq: int = 32
                ) -> Callable[[int], dict]:
    """The port's pure batch function of the step index: step i's tokens
    from ``np.random.RandomState(1000 + i)`` (labels = tokens, as the
    reference's)."""
    def batch_fn(i):
        toks = np.random.RandomState(1000 + i).randint(
            0, vocab, size=(batch, seq)).astype(np.int32)
        return {"tokens": toks, "labels": toks}
    return batch_fn


def tiny_lm(arch: str = "qwen2-1.5b", *, steps: int = 3, n_stages: int = 2,
            accum: int = 1, batch: int = 2, seq: int = 32,
            lr: float = 1e-3, kappa: float = 1.0, optimizer: str = "adamw",
            precision=None, param_seed: int = 0, device="cpu",
            batch_fn: Optional[Callable[[int], dict]] = None):
    """(cfg, plan, batch_fn, spec, params) on the arch's smoke config.

    ``batch_fn`` is a PURE function of the step index (the replay
    contract); by default ``lm_batch_fn``'s, or the caller's (a test hands
    the reference's across).  ``params`` are drawn from
    ``torch.Generator().manual_seed(param_seed)`` on the CPU and placed on
    ``device``."""
    from repro_torch.core import partition
    cfg = get(arch, smoke=True)
    plan = partition.make_plan(cfg, n_stages)
    if batch_fn is None:
        batch_fn = lm_batch_fn(cfg.vocab_size, batch, seq)
    spec = TrainSpec(n_stages=n_stages, kappa=kappa, precision=precision,
                     stages=tuple(StageSpec(steps=steps, lr=lr,
                                            optimizer=optimizer, accum=accum)
                                  for _ in range(n_stages)))
    params = _placed(M.init_params(
        cfg, torch.Generator().manual_seed(param_seed)), device)
    return cfg, plan, batch_fn, spec, params


# --------------------------------------------------------------------------
# serving world
# --------------------------------------------------------------------------

def serve_cfg(arch: str = "qwen2-1.5b", window: int = 0):
    """Smoke config pinned to fp32 compute (token-identity contracts must
    not ride on reduced-precision nondeterminism)."""
    cfg = get(arch, smoke=True).replace(dtype="float32")
    if window:
        cfg = cfg.replace(sliding_window=window)
    return cfg


def serve_params(cfg, seed: int = 0, device="cpu"):
    """Random weights from ``torch.Generator().manual_seed(seed)`` on the
    CPU, placed on ``device``."""
    return _placed(M.init_params(cfg, torch.Generator().manual_seed(seed)),
                   device)


def serve_requests(cfg, lens: Sequence[int] = (8, 12, 5, 10),
                   news: Sequence[int] = (6, 9, 4, 7), *, seed: int = 0,
                   gen_kw: Optional[dict] = None):
    """Mixed-length prompts + mixed durations (staggers admits/retires);
    the reference's prompts, drawn from the same ``RandomState``."""
    from repro_torch.serve import GenerationConfig, Request
    rng = np.random.RandomState(seed)
    kw = gen_kw or {}
    return [Request(tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
                    gen=GenerationConfig(max_new_tokens=nn, **kw),
                    id=f"r{i}")
            for i, (ln, nn) in enumerate(zip(lens, news))]


@torch.no_grad()
def greedy_reference(cfg, params, req, device="cpu") -> Tuple[int, ...]:
    """One-request-at-a-time reference: prefill + per-token python decode,
    on the params as given (no compute copy), on ``device``.

    This is the trusted path every engine optimization (continuous
    batching, fused chunks, staged deployment) must reproduce
    token-for-token."""
    dev = torch.device(device)
    toks = torch.as_tensor(np.asarray(req.tokens, np.int64)[None],
                           device=dev)
    lc = toks.shape[1] + req.gen.max_new_tokens \
        + (cfg.vision_tokens if cfg.frontend == "vision" else 0)
    batch = {"tokens": toks}
    if cfg.enc_dec:
        batch["frames"] = torch.zeros((1, cfg.enc_seq, cfg.d_model),
                                      device=dev)
    if cfg.frontend == "vision":           # the engine's zero stub
        batch["image_embeds"] = torch.zeros(
            (1, cfg.vision_tokens, cfg.d_model), device=dev)
    logits, cache, pos = M.prefill(cfg, params, batch, cache_len=lc)
    tok = torch.argmax(logits[:, : cfg.vocab_size], -1)
    out = [int(tok[0])]
    for i in range(req.gen.max_new_tokens - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, pos + i)
        tok = torch.argmax(logits[:, : cfg.vocab_size], -1)
        out.append(int(tok[0]))
    return tuple(out)
