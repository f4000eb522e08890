"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks, d_ff=0 [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(pattern="ms", proj_factor=2.0, chunk_size=64),
    norm="layernorm", mlp_type="gelu", tie_embeddings=True,
    source="arXiv:2405.04517",
)


def smoke():
    return CONFIG.replace(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                          vocab_size=512, max_seq=4096)
