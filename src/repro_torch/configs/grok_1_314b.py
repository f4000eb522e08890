"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2), norm="rmsnorm", mlp_type="swiglu",
    param_dtype="bfloat16", source="hf:xai-org/grok-1",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          d_ff=512, vocab_size=512, param_dtype="float32",
                          moe=MoEConfig(num_experts=4, top_k=2), max_seq=4096)
