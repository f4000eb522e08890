"""Weights and state carried across from the reference's numpy arrays.

Torch cannot reproduce the reference's threefry random numbers, so tests
hand one set of weights (and SIL tables) to both frameworks through these
functions.  Each takes arrays already converted with ``np.asarray`` and
places the result on ``device``, which defaults to the card like every
entry point of the port (``"cuda"`` raises where torch sees none).

* ``params_from_numpy(cfg, tree)`` — the tree of
  ``repro.models.model.init_params``: the same nested dicts with torch
  tensors, the leading group axis of ``groups`` unstacked into a list of
  per-group dicts.
* ``mlp_params_from_numpy(cfg, tree)`` — the list of ``{"w", "b"}`` of
  ``repro.models.mlp.init_params``.
* ``sil_from_numpy(a)`` — one (d, M) SIL table of ``repro.core.sil``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import group_size
from repro_torch.tree import tree_leaves, tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg, tree: Dict[str, Any], device="cuda"):
    """The port's params from the reference's numpy tree (see module doc)."""
    device = resolve_device(device)
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k != "groups"}
    n = len(next(tree_leaves(tree["groups"])))
    if n * group_size(cfg) != cfg.n_layers:
        raise ValueError(f"{n} stacked groups do not match {cfg.name}'s "
                         f"{cfg.n_layers} layers")
    out["groups"] = [tree_map(lambda a, g=g: _tensor(a[g], device),
                              tree["groups"])
                     for g in range(n)]
    return out


def mlp_params_from_numpy(cfg, tree: Sequence[Dict[str, Any]],
                          device="cuda"):
    """The port's MLP params (a list of ``{"w": (in, out), "b": (out,)}``)
    from the reference's list of numpy dicts."""
    device = resolve_device(device)
    if len(tree) != cfg.n_layers:
        raise ValueError(f"{len(tree)} layers of params for {cfg.name}'s "
                         f"{cfg.n_layers}")
    out = [{"w": _tensor(p["w"], device), "b": _tensor(p["b"], device)}
           for p in tree]
    for i, p in enumerate(out):
        want = (cfg.sizes[i], cfg.sizes[i + 1])
        if tuple(p["w"].shape) != want or tuple(p["b"].shape) != want[1:]:
            raise ValueError(f"layer {i}: w {tuple(p['w'].shape)}, b "
                             f"{tuple(p['b'].shape)}; expected {want}")
    return out


def sil_from_numpy(a, device="cuda") -> torch.Tensor:
    """One (d, M) SIL table as a tensor on ``device``."""
    t = _tensor(a, resolve_device(device))
    if t.dim() != 2:
        raise ValueError(f"a SIL table is (d, M), got {tuple(t.shape)}")
    return t
