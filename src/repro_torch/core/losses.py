"""Losses: stable cross-entropy, the SIL-MSE stage loss, and the training
objective (counterpart of ``repro/core/losses.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.sil_mse import sil_mse


def cross_entropy(logits, labels, mask=None, vocab_size=None):
    """Mean token CE in fp32.  logits (..., V) any float dtype; labels int
    (...).  vocab_size: the real vocab when logits carry padded columns
    (masked out)."""
    lf = logits.float()
    if vocab_size is not None and vocab_size < lf.shape[-1]:
        pad = torch.arange(lf.shape[-1], device=lf.device) < vocab_size
        lf = torch.where(pad, lf, torch.full((), -1e30, device=lf.device))
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def accuracy(logits, labels, mask=None):
    hit = (torch.argmax(logits, dim=-1) == labels.long()).float()
    if mask is not None:
        m = mask.float()
        return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)
    return hit.mean()


def sil_stage_loss(boundary_act, sil, labels):
    """The paper's left-partition loss: MSE(boundary, SIL[:, y]).

    boundary_act: (..., d); labels: int (...) matching the leading dims.
    Tokens are flattened and go through the fused kernel path."""
    d = boundary_act.shape[-1]
    return sil_mse(boundary_act.reshape(-1, d), sil, labels.reshape(-1))


def train_objective(cfg, logits, labels, aux, mask=None):
    """CE (+ MoE auxiliary losses in the reference; those are not ported,
    so a config with ``moe`` raises)."""
    if getattr(cfg, "moe", None) is not None:
        raise NotImplementedError("MoE auxiliary losses are not ported yet")
    loss = cross_entropy(logits, labels, mask,
                         vocab_size=getattr(cfg, "vocab_size", None))
    return loss, {"ce": loss, "loss": loss}
