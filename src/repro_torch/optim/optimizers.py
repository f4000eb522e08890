"""Optimizers over the port's parameter trees (counterpart of
``repro/optim/optimizers.py``).

API as the reference's: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (params, state)``.  ``grads`` is any
tree (or flat list) whose leaves line up with ``tree_leaves(params)``.
Where the reference returns new arrays, the port updates the parameter and
state tensors in place (multi-tensor ``torch._foreach_*`` ops: three launches
per step for the whole tree), which saves a copy of both per step; the
returned objects are the ones passed in.  The trainer hands its own copies
to the optimizer (``MLPBackend.split``), so a caller's tensors are never
changed.  Learning-rate schedules are functions of ``state["count"]``, an
int32 tensor on the params' device.

The paper trains with SGD + momentum (lr=0.01, momentum=0.9); the LM
stages train with ``adamw`` (the reference's launcher), and ``adafactor``
and the ``mixed_precision`` wrapper (loss scaling, fp32 master weights) are
here too.  Every optimizer keeps fp32 state and fp32 update math, with the
reference's bias correction and factoring; half-precision params are
updated in fp32 and rounded back.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    name: str


def _leaves(tree) -> list:
    return list(tree_leaves(tree))


def sgd_momentum(lr=0.01, momentum=0.9) -> Optimizer:
    """SGD+momentum with fp32 momentum and fp32 update math:
    ``mu = momentum * mu + g``; ``p = p - lr * mu``.  Half-precision params
    are updated in fp32 and rounded back."""

    def init(params):
        ps = _leaves(params)
        dev = ps[0].device if ps else None
        return {"mu": [torch.zeros_like(p, dtype=torch.float32) for p in ps],
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        ps, gs, mu = _leaves(params), _leaves(grads), state["mu"]
        if len(gs) != len(ps):
            raise ValueError(f"{len(gs)} grads for {len(ps)} params")
        gs = [g.float() for g in gs]
        torch._foreach_mul_(mu, momentum)
        torch._foreach_add_(mu, gs)
        step = torch._foreach_mul(mu, lr(state["count"])) if callable(lr) \
            else None
        if all(p.dtype == torch.float32 for p in ps):
            if step is None:
                torch._foreach_add_(ps, mu, alpha=-lr)
            else:
                torch._foreach_sub_(ps, step)
        else:
            for i, (p, m) in enumerate(zip(ps, mu)):
                s = m * lr if step is None else step[i]
                p.copy_((p.float() - s).to(p.dtype))
        state["count"].add_(1)
        return params, state

    return Optimizer(init, update, "sgdm")


def _as_fp32(ps) -> list:
    """The params as fp32 tensors to update: the tensors themselves where
    they are fp32, fp32 copies otherwise (``_write_back`` rounds those)."""
    return [p if p.dtype == torch.float32 else p.float() for p in ps]


def _write_back(ps, pf) -> None:
    for p, f in zip(ps, pf):
        if f is not p:
            p.copy_(f.to(p.dtype))


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    """AdamW with fp32 moments: ``m = b1 m + (1-b1) g``, ``v = b2 v +
    (1-b2) g^2``, ``p -= lr (m / bc1) / (sqrt(v / bc2) + eps)`` (+ decoupled
    ``weight_decay * p``), bc = 1 - b^count, in the reference's order."""

    def init(params):
        ps = _leaves(params)
        dev = ps[0].device if ps else None
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in ps],
                "v": [torch.zeros_like(p, dtype=torch.float32) for p in ps],
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        ps, gs, m, v = _leaves(params), _leaves(grads), state["m"], state["v"]
        if len(gs) != len(ps):
            raise ValueError(f"{len(gs)} grads for {len(ps)} params")
        gs = [g.float() for g in gs]
        step_lr = lr(state["count"]) if callable(lr) else lr
        c = (state["count"] + 1).float()
        bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(gs, 1 - b1))
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, g2)
        del g2
        pf = _as_fp32(ps)
        step = torch._foreach_div(m, bc1)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(step, denom)
        del denom
        if weight_decay:
            torch._foreach_add_(step, torch._foreach_mul(pf, weight_decay))
        torch._foreach_mul_(step, step_lr)
        torch._foreach_sub_(pf, step)
        _write_back(ps, pf)
        state["count"].add_(1)
        return params, state

    return Optimizer(init, update, "adamw")


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_threshold=1.0,
              min_dim_size_to_factor=32) -> Optimizer:
    """Shazeer & Stern Adafactor (factored second moments, no momentum), as
    the reference's: a leaf whose last two dims are both at least
    ``min_dim_size_to_factor`` keeps row and column accumulators, any other
    a full one; updates are clipped by their RMS and scaled by the param's
    RMS (at least 1e-3)."""

    def factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_size_to_factor \
            and p.shape[-2] >= min_dim_size_to_factor

    def init(params):
        ps = _leaves(params)
        dev = ps[0].device if ps else None

        def st(p):
            z = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"v": [st(p) for p in ps],
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        ps, gs = _leaves(params), _leaves(grads)
        if len(gs) != len(ps):
            raise ValueError(f"{len(gs)} grads for {len(ps)} params")
        step_lr = lr(state["count"]) if callable(lr) else lr
        c = (state["count"] + 1).float()
        beta = 1.0 - torch.pow(c, -decay)
        for p, g, v in zip(ps, gs, state["v"]):
            gf = g.float()
            g2 = gf * gf + eps
            if "vr" in v:
                v["vr"].copy_(beta * v["vr"] + (1 - beta) * g2.mean(-1))
                v["vc"].copy_(beta * v["vc"] + (1 - beta) * g2.mean(-2))
                vr, vc = v["vr"], v["vc"]
                denom = (vr / torch.clamp(vr.mean(-1, keepdim=True),
                                          min=eps))[..., None] \
                    * vc[..., None, :]
                u = gf * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
                u = gf * torch.rsqrt(torch.clamp(v["v"], min=eps))
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            scale = torch.clamp(torch.sqrt(torch.mean(pf * pf)), min=1e-3)
            p.copy_((pf - step_lr * scale * u).to(p.dtype))
        state["count"].add_(1)
        return params, state

    return Optimizer(init, update, "adafactor")


def _finite(grads) -> torch.Tensor:
    """Scalar bool tensor: every element of every leaf is finite."""
    return torch.stack([torch.isfinite(g).all() for g in _leaves(grads)]
                       ).all()


def mixed_precision(inner: Optimizer, *, loss_scale: float = 1.0,
                    dynamic: bool = False,
                    growth_interval: int = 200) -> Optimizer:
    """Loss scaling and fp32 master weights around ``inner``.

    The step builder computes gradients of ``loss * state["loss_scale"]``
    (``precision.read_loss_scale``); this wrapper unscales them in fp32 and
    applies ``inner`` to fp32 master weights, kept only where params are
    stored in half precision, then rounds them into the params.  With
    ``dynamic=True`` a step whose unscaled gradients hold an inf/nan leaves
    params and state as they were, counts one in ``skipped`` and halves the
    scale (not below 1); ``growth_interval`` clean steps in a row double it.
    As in ``step_guard`` everything is a ``torch.where`` on the device, and
    with ``loss_scale=1`` and fp32 params the wrapper equals ``inner`` bit
    for bit."""

    def needs_master(params):
        return any(p.is_floating_point() and p.dtype != torch.float32
                   for p in _leaves(params))

    def init(params):
        ps = _leaves(params)
        dev = ps[0].device if ps else None
        state = {"loss_scale": torch.tensor(float(loss_scale),
                                            dtype=torch.float32, device=dev),
                 "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
                 "skipped": torch.zeros((), dtype=torch.int32, device=dev)}
        if needs_master(params):
            state["master"] = [p.float() if p.is_floating_point()
                               else p.clone() for p in ps]
            state["inner"] = inner.init(state["master"])
        else:
            state["inner"] = inner.init(params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        scale = state["loss_scale"]
        g = [x.float() / scale for x in _leaves(grads)]
        finite = _finite(g)
        g_safe = [torch.where(finite, x, torch.zeros_like(x)) for x in g]
        master = state.get("master", params)
        before = [t.clone() for t in _leaves(master)] + \
            [t.clone() for t in _leaves(state["inner"])]
        inner.update(g_safe, state["inner"], master)
        after = _leaves(master) + _leaves(state["inner"])
        for new, old in zip(after, before):
            new.copy_(torch.where(finite, new, old))
        if dynamic:
            good = torch.where(finite, state["good_steps"] + 1,
                               torch.zeros_like(state["good_steps"]))
            grow = finite & (good >= growth_interval)
            state["loss_scale"] = torch.where(
                grow, scale * 2.0,
                torch.where(finite, scale, torch.clamp(scale * 0.5,
                                                       min=1.0)))
            state["good_steps"] = torch.where(grow, torch.zeros_like(good),
                                              good)
        state["skipped"].add_((~finite).to(torch.int32))
        if "master" in state:
            for p, m in zip(_leaves(params), state["master"]):
                p.copy_(m.to(p.dtype))
        return params, state

    return Optimizer(init, update, f"mp({inner.name})")


def step_guard(inner: Optimizer) -> Optimizer:
    """NaN/inf step guard for the unscaled precisions.

    A step whose gradients contain inf/nan leaves params AND inner optimizer
    state as they were and adds one to a device-resident ``skipped``
    counter; everything is ``torch.where`` on the card, with no host sync.
    On a clean step the selects pick the inner update, so the wrapper equals
    the inner optimizer bit for bit."""

    def init(params):
        ps = _leaves(params)
        dev = ps[0].device if ps else None
        return {"inner": inner.init(params),
                "skipped": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        finite = _finite(grads)
        g_safe = [torch.where(finite, g, torch.zeros_like(g))
                  for g in _leaves(grads)]
        before = [t.clone() for t in _leaves(params)] + \
            [t.clone() for t in _leaves(state["inner"])]
        inner.update(g_safe, state["inner"], params)
        after = _leaves(params) + _leaves(state["inner"])
        for new, old in zip(after, before):
            new.copy_(torch.where(finite, new, old))
        state["skipped"].add_((~finite).to(torch.int32))
        return params, state

    return Optimizer(init, update, f"guard({inner.name})")


def read_skipped(opt_state):
    """Device-resident skipped-step counter of a ``step_guard`` or
    ``mixed_precision`` state, or ``None`` when the optimizer is unguarded.  Reading it on the host is the
    caller's (end-of-phase) decision."""
    if isinstance(opt_state, dict) and "skipped" in opt_state:
        return opt_state["skipped"]
    return None


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"sgdm": sgd_momentum, "adamw": adamw,
            "adafactor": adafactor}[name](lr=lr, **kw)

