"""Batched token sampling on the device, counterpart of
``repro/serve/sampling.py``.

All knobs are per-slot tensors (temperature, top_k, top_p), so one call
serves a continuous batch with heterogeneous configs and nothing goes
through the host per token.  Conventions (matching ``GenerationConfig``):
temperature <= 0 -> greedy, top_k == 0 -> no top-k filter, top_p >= 1 -> no
nucleus filter.

Randomness is a per-slot counter-based stream: the Gumbel noise for
vocabulary entry v of a request at sampling step t is a fixed integer hash
of (seed, t, v), computed with tensor ops on the logits' device.  A
request's tokens therefore depend only on its seed and its logits, never on
its slot or its batch mates.  (The numbers differ from the reference's
threefry stream; only the distribution and the independence carry over.)
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values < 2**32
    (products stay below 2**63, so no step overflows)."""
    x = x & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def uniforms(seeds: torch.Tensor, steps: torch.Tensor, v: int) -> torch.Tensor:
    """(S, v) float32 uniforms in (0, 1) from per-slot (seed, step)."""
    key = _mix32(_mix32(seeds.long()) ^ _mix32(steps.long() + 0x9E3779B9))
    idx = torch.arange(v, device=seeds.device, dtype=torch.int64)
    h = _mix32(key[:, None] ^ _mix32(idx * 0x2C1B3C6D + 0x297A2D39)[None, :])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def filter_logits(logits, top_k, top_p):
    """Fused top-k + nucleus filter off one descending sort.

    logits: (S, V); top_k: (S,) int (0 disables); top_p: (S,) float (>= 1
    disables).  Top-k caps the kept prefix at k, top-p at the smallest
    prefix with cumulative prob >= p over the top-k-renormalised
    distribution; rank 0 always survives."""
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    rank = torch.arange(v, device=logits.device)[None, :]
    keep_k = (top_k <= 0)[:, None] | (rank < top_k[:, None])
    probs = torch.softmax(desc.masked_fill(~keep_k, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (top_p >= 1.0)[:, None] | ((cum - probs) < top_p[:, None]) \
        | (rank == 0)
    keep = keep_k & keep_p
    cutoff = desc.masked_fill(~keep, float("inf")).amin(dim=-1)
    return logits.masked_fill(logits < cutoff[:, None], NEG_INF)


def mode_for(configs) -> str:
    """Cheapest sufficient sampling mode for a set of GenerationConfigs:
    "greedy" skips sampling, "temp" skips the top-k/top-p sort, "full"
    does everything.  Disabled knobs are no-ops, so the mode never changes
    tokens."""
    if all(g.temperature <= 0 for g in configs):
        return "greedy"
    if all(g.top_k == 0 and g.top_p >= 1.0 for g in configs):
        return "temp"
    return "full"


def sample_tokens(logits, seeds, steps, temperature, top_k, top_p, *,
                  mode="full"):
    """One sampling step for a continuous batch.

    logits: (S, V) already sliced to the real vocab; seeds, steps: (S,)
    int64 per-slot stream keys; temperature/top_k/top_p: (S,) tensors.
    Returns (S,) int32 tokens."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if mode == "greedy":
        return greedy
    lg = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    if mode == "full":
        lg = filter_logits(lg, top_k, top_p)
    gumbel = -torch.log(-torch.log(uniforms(seeds, steps, lg.shape[-1])))
    drawn = torch.argmax(lg + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, drawn)
