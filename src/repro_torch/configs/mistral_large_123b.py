"""mistral-large-123b [dense] — 88L GQA kv=8 [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=28672, vocab_size=32768,
    rope_theta=1e6, norm="rmsnorm", mlp_type="swiglu",
    param_dtype="bfloat16", source="hf:mistralai/Mistral-Large-Instruct-2407",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                          d_ff=512, vocab_size=512, param_dtype="float32",
                          max_seq=4096)
