"""Weight conversion from the reference's parameter tree.

``params_from_numpy(cfg, tree, device)`` takes the tree of
``repro.models.model.init_params`` with every leaf already a numpy array
(the caller maps ``np.asarray`` over it) and returns the port's params:
the same nested dicts with torch tensors, the leading group axis of
``groups`` unstacked into a list of per-group dicts.  It is how tests hand
one set of weights to both frameworks, since torch cannot reproduce the
reference's threefry random numbers.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.model import group_size
from repro_torch.tree import tree_leaves, tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg, tree: Dict[str, Any], device="cpu"):
    """The port's params from the reference's numpy tree (see module doc)."""
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
