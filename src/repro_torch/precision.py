"""Mixed-precision policy (param / compute / accum dtypes), counterpart of
``repro/precision.py``.

* **param_dtype** — storage dtype of the weights.
* **compute_dtype** — activations, matmul inputs and the KV cache.
* **accum_dtype** — norms, softmax/attention logits, residual adds.  Always
  fp32 in the built-in policies.

Under the fp32 policy ``apply_backend_flags`` turns TF32 off for CUDA
matmuls and cuDNN, so fp32 means full fp32 on the card as on the CPU.  The
MLP training path calls it for the fp32 policy and when no policy is given;
the LM path for the policy its model config runs (``policy_for``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class PrecisionPolicy:
    name: str = "fp32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    accum_dtype: str = "float32"
    loss_scale: float = 1.0
    dynamic_scale: bool = False
    scale_growth_interval: int = 200

    @property
    def compute_torch(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def wraps_optimizer(self) -> bool:
        """Whether the step needs the mixed_precision optimizer wrapper
        (loss scaling and/or fp32 master weights for half-precision
        params)."""
        return (self.loss_scale != 1.0 or self.dynamic_scale
                or self.param_dtype != "float32")

    def cast_compute(self, tree):
        """Cast floating leaves to compute_dtype (ints/bools untouched)."""
        return cast_floating(tree, self.compute_torch)

    def apply_to_model(self, cfg):
        """ModelConfig with activations in this policy's compute dtype
        (param_dtype is left as the config declares it)."""
        if cfg.dtype == self.compute_dtype:
            return cfg
        return cfg.replace(dtype=self.compute_dtype)

    def apply_backend_flags(self) -> None:
        """fp32 compute means no TF32 in CUDA matmuls or cuDNN (process-wide
        torch flags; the other policies leave them as they are)."""
        if self.compute_dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


PRESETS = {
    "fp32": PrecisionPolicy(name="fp32"),
    "bf16": PrecisionPolicy(name="bf16", compute_dtype="bfloat16"),
    "fp16": PrecisionPolicy(name="fp16", compute_dtype="float16",
                            loss_scale=float(2 ** 15), dynamic_scale=True),
}


def get_policy(p: Union[None, str, PrecisionPolicy],
               default: str = "fp32") -> PrecisionPolicy:
    """Resolve a policy from a preset name / policy / None (-> default)."""
    if p is None:
        p = default
    if isinstance(p, PrecisionPolicy):
        return p
    try:
        return PRESETS[p]
    except KeyError:
        raise ValueError(f"unknown precision {p!r}; "
                         f"presets: {sorted(PRESETS)}") from None


def policy_for(cfg) -> PrecisionPolicy:
    """The policy a ModelConfig runs on its own (its ``dtype`` and
    ``param_dtype``), e.g. to set the backend flags of an fp32 model."""
    return PrecisionPolicy(name="derived", compute_dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype)


def cast_floating(tree, dtype):
    """Cast every floating leaf of a tree to ``dtype``; other leaves pass
    through (labels, masks and counters keep their integer dtypes)."""
    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point() \
                and x.dtype != dtype:
            return x.to(dtype)
        return x
    return tree_map(cast, tree) if isinstance(tree, (dict, list, tuple)) \
        else cast(tree)


def read_loss_scale(opt_state):
    """The live loss scale of a mixed_precision optimizer state (1.0 for an
    unwrapped optimizer); step builders multiply the loss by it."""
    if isinstance(opt_state, dict) and "loss_scale" in opt_state:
        return opt_state["loss_scale"]
    return 1.0


def tree_bytes(tree) -> int:
    """Total bytes of the tensors in a nested dict/list."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
