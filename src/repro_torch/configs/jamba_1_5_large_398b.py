"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE 16e top-2 every other
layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, every=2), attn_period=8,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2), norm="rmsnorm",
    mlp_type="swiglu", param_dtype="bfloat16", source="arXiv:2403.19887",
)


def smoke():
    # attn_period reduced to 2 so a small smoke still exercises the full
    # block-kind pattern (1 mamba+MoE layer, 1 attn+dense layer)
    return CONFIG.replace(n_layers=4, attn_period=2, d_model=256, n_heads=4,
                          n_kv_heads=2, d_ff=512, vocab_size=512,
                          param_dtype="float32",
                          moe=MoEConfig(num_experts=4, top_k=2, every=2),
                          max_seq=4096)
