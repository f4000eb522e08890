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

The paper trains with SGD + momentum (lr=0.01, momentum=0.9).  ``adamw``,
``adafactor`` and ``mixed_precision`` wait for the LM slice of the port.
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


def _not_ported(name):
    def make(*args, **kw):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet "
                                  "(LM slice); the paper MLP trains with "
                                  "'sgdm'")
    return make


adamw = _not_ported("adamw")
adafactor = _not_ported("adafactor")
mixed_precision = _not_ported("mixed_precision")


def _finite(grads) -> torch.Tensor:
    """Scalar bool tensor: every element of every leaf is finite."""
    return torch.stack([torch.isfinite(g).all() for g in _leaves(grads)]
                       ).all()


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
    """Device-resident skipped-step counter of a ``step_guard`` state, or
    ``None`` when the optimizer is unguarded.  Reading it on the host is the
    caller's (end-of-phase) decision."""
    if isinstance(opt_state, dict) and "skipped" in opt_state:
        return opt_state["skipped"]
    return None


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"sgdm": sgd_momentum, "adamw": adamw,
            "adafactor": adafactor}[name](lr=lr, **kw)

