"""stablelm-3b [dense] — MHA kv=32, partial rotary [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=6912, vocab_size=50304, rope_fraction=0.25,
    norm="layernorm", mlp_type="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                          d_ff=512, vocab_size=512, max_seq=4096)
