"""Synthetic language-model data: a deterministic Markov/induction corpus
(a copy of ``repro/data/lm.py``; numpy only, bit-identical arrays).

Structure (so training loss actually decreases):
* a class-conditional bigram backbone: token t+1 ~ M[t] over a sparse
  transition table, plus
* induction patterns: random earlier spans are repeated verbatim, rewarding
  models with working context.
"""
from __future__ import annotations

import numpy as np


def synthetic_token_stream(n_tokens: int, vocab: int, seed: int = 0,
                           branch: int = 16, repeat_p: float = 0.1,
                           span: int = 32) -> np.ndarray:
    rng = np.random.RandomState(seed)
    # sparse deterministic transition table: each token has `branch` successors
    succ = rng.randint(0, vocab, size=(min(vocab, 4096), branch))
    out = np.empty(n_tokens, dtype=np.int64)
    t = rng.randint(vocab)
    i = 0
    while i < n_tokens:
        if i > 2 * span and rng.rand() < repeat_p:
            start = rng.randint(0, i - span)
            ln = rng.randint(4, span)
            ln = min(ln, n_tokens - i)
            out[i:i + ln] = out[start:start + ln]
            i += ln
            t = int(out[i - 1])
            continue
        out[i] = t
        t = int(succ[t % succ.shape[0], rng.randint(branch)])
        i += 1
    return out.astype(np.int32) % vocab


def lm_batches(stream: np.ndarray, batch: int, seq: int, seed: int = 0):
    """Yields {'tokens': (B,S), 'labels': (B,S)} forever (labels = next token)."""
    n = (len(stream) - 1) // seq
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.randint(0, n, size=batch)
        toks = np.stack([stream[i * seq:(i + 1) * seq] for i in idx])
        labs = np.stack([stream[i * seq + 1:(i + 1) * seq + 1] for i in idx])
        yield {"tokens": toks, "labels": labs}


def lm_batch_at(stream: np.ndarray, batch: int, seq: int, step: int,
                seed: int = 0) -> dict:
    """Batch for step `step` as a pure function of the index: the same
    (tokens, labels) whatever the call order or how often it is called."""
    n = (len(stream) - 1) // seq
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence((seed, step))))
    idx = rng.integers(0, n, size=batch)
    toks = np.stack([stream[i * seq:(i + 1) * seq] for i in idx])
    labs = np.stack([stream[i * seq + 1:(i + 1) * seq + 1] for i in idx])
    return {"tokens": toks, "labels": labs}
