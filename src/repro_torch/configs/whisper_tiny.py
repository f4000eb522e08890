"""whisper-tiny [audio] — enc-dec, conv/mel frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384, n_heads=6,
    n_kv_heads=6, d_ff=1536, vocab_size=51865, norm="layernorm",
    mlp_type="gelu", enc_dec=True, enc_layers=4, enc_seq=1500,
    frontend="audio", max_seq=32768, source="arXiv:2212.04356",
)


def smoke():
    return CONFIG.replace(n_layers=2, enc_layers=2, d_model=128, n_heads=4,
                          n_kv_heads=4, d_ff=256, vocab_size=512, enc_seq=64,
                          max_seq=4096)
