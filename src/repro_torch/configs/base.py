"""Model configuration for the PyTorch port (counterpart of
``repro/configs/base.py``).

Only the fields and helpers the ported slice reads are kept; the dtype
strings ("bfloat16", "float32", ...) are resolved to ``torch.dtype`` by
``torch_dtype``.  ``get(name)`` resolves an architecture module of this
package (``CONFIG`` or ``smoke()``).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a dtype string (or a torch dtype, passed through)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") \
            from None


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN parameters (``models.layers.moe_apply``):
    token-choice top-k routing with per-expert capacity, and the switch
    load-balance and router z-loss coefficients of the training
    objective."""
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    # Apply MoE to every `every` FFN (1 = all layers).
    every: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM block parameters."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    """Alternating sLSTM/mLSTM block pattern. 'm'/'s' per layer, cycled."""
    pattern: str = "ms"
    proj_factor: float = 2.0  # up-projection inside mLSTM blocks
    chunk_size: int = 64      # chunkwise-parallel mLSTM chunk


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    sliding_window: int = 0      # 0 = full attention; >0 ring cache + window mask
    norm: str = "rmsnorm"
    mlp_type: str = "swiglu"
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    # hybrid (jamba): one attention layer per `attn_period` layers, rest mamba
    attn_period: int = 0
    ssm: Optional[SSMConfig] = None
    # xLSTM (family "ssm"): mLSTM / sLSTM blocks by ``xlstm.pattern``
    xlstm: Optional[XLSTMConfig] = None
    # encoder-decoder (whisper): the decoder has n_layers, the encoder
    # enc_layers over a fixed enc_seq frames of a stubbed frontend
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0
    # modality frontend stub: none | audio | vision
    frontend: str = "none"
    vision_tokens: int = 0       # VLM: patch-embedding rows before the text
    # MoE dispatch: split the tokens into N independent dispatch groups,
    # each with its own capacity (0 or 1: one group)
    moe_dispatch_groups: int = 0
    # the reference's sharding constraint on the expert weights before their
    # products; the port runs on one card and refuses True
    moe_gather_weights: bool = False
    # numerics: `dtype` is the compute dtype (activations, matmul inputs, KV
    # cache), `param_dtype` the weight storage dtype; norms, softmax and
    # residual adds run in fp32
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    max_seq: int = 131072
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding tables are padded to a multiple of 128 rows."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def block_kind(self, layer: int) -> str:
        """Kind of block at `layer`: attn | mamba | slstm | mlstm."""
        if self.family == "ssm" and self.xlstm is not None:
            c = self.xlstm.pattern[layer % len(self.xlstm.pattern)]
            return {"m": "mlstm", "s": "slstm"}[c]
        if self.attn_period and (layer % self.attn_period
                                 != self.attn_period - 1):
            return "mamba"
        return "attn"

    def layer_is_moe(self, layer: int) -> bool:
        return self.moe is not None and (layer % self.moe.every == 0)

    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_counts(self) -> dict:
        """Returns dict with total and active parameter counts (embeddings included
        in total, excluded from 'matmul' counts used for 6ND)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        embed = V * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        if self.qkv_bias:
            per_layer_attn += (H + 2 * KV) * hd
        if self.mlp_type == "swiglu":
            per_layer_ffn = 3 * d * ff
        else:
            per_layer_ffn = 2 * d * ff
        # mamba block params
        ssm = self.ssm or SSMConfig()
        d_in = ssm.expand * d
        dt_rank = ssm.dt_rank or -(-d // 16)
        per_mamba = (d * 2 * d_in + ssm.d_conv * d_in
                     + d_in * (dt_rank + 2 * ssm.d_state) + dt_rank * d_in
                     + d_in * d + 2 * d_in)
        # xlstm blocks
        x = self.xlstm or XLSTMConfig()
        d_up = int(x.proj_factor * d)
        per_mlstm = d * d_up * 2 + 3 * d_up * d_up + d_up * d  # up, q/k/v+gates, down
        per_slstm = 4 * d * d + 4 * d * d + d * d              # in/rec/out proj approx
        total = embed
        active = embed
        for l in range(self.n_layers):
            kind = self.block_kind(l)
            if kind == "attn":
                total += per_layer_attn
                active += per_layer_attn
            elif kind == "mamba":
                total += per_mamba
                active += per_mamba
            elif kind == "mlstm":
                total += per_mlstm
                active += per_mlstm
            elif kind == "slstm":
                total += per_slstm
                active += per_slstm
            if kind in ("attn", "mamba") and ff > 0:
                if self.layer_is_moe(l):
                    m = self.moe
                    total += m.num_experts * per_layer_ffn + d * m.num_experts
                    active += m.top_k * per_layer_ffn + d * m.num_experts
                else:
                    total += per_layer_ffn
                    active += per_layer_ffn
        if self.enc_dec:
            # encoder self-attn + gelu ffn; decoder cross-attn
            total += self.enc_layers * (per_layer_attn + 2 * d * ff)
            active += self.enc_layers * (per_layer_attn + 2 * d * ff)
            total += self.n_layers * per_layer_attn  # cross-attention
            active += self.n_layers * per_layer_attn
        return {"total": int(total), "active": int(active), "embed": int(embed)}


ARCH_NAMES = ["qwen2-1.5b", "jamba-1.5-large-398b", "granite-moe-3b-a800m",
              "stablelm-3b", "chatglm3-6b", "mistral-large-123b",
              "grok-1-314b", "whisper-tiny", "xlstm-125m", "llava-next-34b"]


def get(name: str, smoke: bool = False) -> ModelConfig:
    """Resolve an architecture config by id (module name uses underscores)."""
    if name not in ARCH_NAMES:
        raise ValueError(f"architecture {name!r} is not ported yet; "
                         f"ported: {ARCH_NAMES}")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.smoke() if smoke else mod.CONFIG
