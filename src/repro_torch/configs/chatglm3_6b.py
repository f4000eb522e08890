"""chatglm3-6b [dense] — 2d (half-dim) RoPE, GQA kv=2, QKV bias [arXiv:2406.12793]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096, n_heads=32,
    n_kv_heads=2, d_ff=13696, vocab_size=65024, qkv_bias=True,
    rope_fraction=0.5, norm="rmsnorm", mlp_type="swiglu",
    source="arXiv:2406.12793",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          d_ff=512, vocab_size=512, max_seq=4096)
