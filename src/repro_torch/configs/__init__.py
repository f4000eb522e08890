from repro_torch.configs.base import (  # noqa: F401
    ARCH_NAMES, ModelConfig, MoEConfig, SSMConfig, XLSTMConfig, get,
    torch_dtype)
