"""Input stand-ins for every (arch x input-shape) pair (counterpart of
``repro/launch/specs.py``).

Tensors on the ``meta`` device: a shape and a dtype with no storage, the
port's counterpart of ``jax.ShapeDtypeStruct``, so the full-size shapes
cost nothing to build.  The modality frontends are stubbed here by
construction: audio archs receive precomputed frame embeddings (B,
enc_seq, d), VLMs receive patch embeddings (B, vision_tokens, d).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M

META = torch.device("meta")


def spec(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` with no storage."""
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig,
                      shape: InputShape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    s_text = s
    if cfg.frontend == "vision":
        s_text = s - cfg.vision_tokens
        specs["image_embeds"] = spec((b, cfg.vision_tokens, cfg.d_model),
                                     torch.bfloat16)
    specs["tokens"] = spec((b, s_text), torch.int32)
    if cfg.enc_dec:
        specs["frames"] = spec((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    specs["labels"] = spec((b, s_text), torch.int32)
    return specs


def prefill_batch_specs(cfg: ModelConfig,
                        shape: InputShape) -> Dict[str, torch.Tensor]:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_specs(cfg: ModelConfig, shape: InputShape):
    """(cache, token, pos) stand-ins for a decode step; the cache is
    ``init_cache``'s tree, built on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    cache = M.init_cache(cfg, b, s, device=META)
    token = spec((b,), torch.int32)
    pos = spec((), torch.int32)
    return cache, token, pos


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple:
    """(ok, reason). Encodes DESIGN.md §4.2 skip policy."""
    if shape.name == "long_500k":
        if cfg.enc_dec:
            return False, ("enc-dec full-attention decoder; no faithful "
                           "sliding-window variant (DESIGN.md §4.2)")
    return True, ""


def arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-conditional config tweaks (the long-context sliding window)."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        # sub-quadratic requirement: dense/moe/vlm attention runs the
        # sliding-window variant (SSM/hybrid are already sub-quadratic)
        return cfg.replace(sliding_window=8192)
    if shape.name == "long_500k" and cfg.family == "hybrid":
        # jamba: mamba layers are O(1); its sparse attention layers keep the
        # full 500k cache (9 layers — see DESIGN.md §4.2 memory accounting)
        return cfg
    return cfg
