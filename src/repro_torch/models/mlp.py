"""The paper's fully-connected classification network (§3), counterpart of
``repro/models/mlp.py``.

Base network: 784 -> 80 -> 60 -> 60 -> 60 -> 47, ReLU activations except the
final (identity) layer.  Exposes a layer-granular forward so the trainer can
cut it at any boundary (the paper cuts after the 2nd hidden layer: left =
[784->80->60], right = [60->60->60->47]).  Params are a list of
``{"w": (in, out), "b": (out,)}``, the reference's layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class MLPConfig:
    name: str = "paper_mlp"
    sizes: Tuple[int, ...] = (784, 80, 60, 60, 60, 47)  # paper §3
    cut: int = 2          # partition boundary: after hidden layer `cut`
    n_classes: int = 47

    @property
    def n_layers(self) -> int:
        return len(self.sizes) - 1

    @property
    def boundary_width(self) -> int:
        return self.sizes[self.cut]


def init_params(cfg: MLPConfig, gen: Optional[torch.Generator] = None,
                device=None) -> List[dict]:
    """PyTorch-default-style init (U(-1/sqrt(fan_in), 1/sqrt(fan_in))),
    drawn from ``gen`` on its device and placed on ``device``."""
    gdev = gen.device if gen is not None else torch.device("cpu")
    params = []
    for i in range(cfg.n_layers):
        fan_in, fan_out = cfg.sizes[i], cfg.sizes[i + 1]
        bound = 1.0 / math.sqrt(fan_in)

        def u(shape):
            r = torch.rand(shape, generator=gen, device=gdev)
            return (r * (2 * bound) - bound).to(device or gdev)
        params.append({"w": u((fan_in, fan_out)), "b": u((fan_out,))})
    return params


def forward_range(cfg: MLPConfig, params: Sequence[dict], x, lo: int,
                  hi: int, *, final_identity: bool = True,
                  compute_dtype=None):
    """Apply layers [lo, hi).  ReLU after every layer except the network's
    last (identity, per the paper).

    compute_dtype: optional mixed-precision compute dtype (a torch dtype):
    inputs and weights are cast to it at each matmul while the stored
    params stay fp32.  None (default) is the paper-exact fp32 path."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i in range(lo, hi):
        w, b = params[i - lo]["w"], params[i - lo]["b"]
        if compute_dtype is not None:
            w, b = w.to(compute_dtype), b.to(compute_dtype)
        x = x @ w + b
        if i < cfg.n_layers - 1 or not final_identity:
            x = torch.relu(x)
    return x


def forward(cfg: MLPConfig, params, x):
    return forward_range(cfg, params, x, 0, cfg.n_layers)


def macs(cfg: MLPConfig, lo: int = 0, hi: int = None) -> int:
    """Multiply-accumulate ops per sample for layers [lo, hi) -- the paper's
    cost unit (its ptflops accounting: weights + biases)."""
    hi = cfg.n_layers if hi is None else hi
    return sum(cfg.sizes[i] * cfg.sizes[i + 1] + cfg.sizes[i + 1]
               for i in range(lo, hi))
