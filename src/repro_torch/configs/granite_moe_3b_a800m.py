"""granite-moe-3b-a800m [moe] — 40 experts top-8, d_ff=512.

The structured field gives 40 experts (a trailing note of the reference's
header says 32); both packages follow the field.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155,
    moe=MoEConfig(num_experts=40, top_k=8), norm="rmsnorm", mlp_type="swiglu",
    tie_embeddings=True, source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512,
                          moe=MoEConfig(num_experts=4, top_k=2), max_seq=4096)
