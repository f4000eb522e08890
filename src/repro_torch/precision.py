"""Mixed-precision policy (param / compute / accum dtypes), counterpart of
``repro/precision.py``.

* **param_dtype** — storage dtype of the weights.
* **compute_dtype** — activations, matmul inputs and the KV cache.
* **accum_dtype** — norms, softmax/attention logits, residual adds.  Always
  fp32 in the built-in policies.

Under the fp32 policy ``apply_backend_flags`` turns TF32 off for CUDA
matmuls and cuDNN, so fp32 means full fp32 on the card as on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from repro_torch.tree import tree_leaves

@dataclass(frozen=True)
class PrecisionPolicy:
    name: str = "fp32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    accum_dtype: str = "float32"
    loss_scale: float = 1.0
    dynamic_scale: bool = False
    scale_growth_interval: int = 200

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


def tree_bytes(tree) -> int:
    """Total bytes of the tensors in a nested dict/list."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
