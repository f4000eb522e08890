"""llava-next-34b [vlm] — anyres tiling; vision encoder stubbed, patch
embeddings enter via input_specs [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=20480, vocab_size=64000, frontend="vision",
    vision_tokens=2880,  # anyres: 4 tiles + base, 576 patches each
    norm="rmsnorm", mlp_type="swiglu", param_dtype="bfloat16",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          d_ff=512, vocab_size=512, vision_tokens=16,
                          param_dtype="float32", max_seq=4096)
