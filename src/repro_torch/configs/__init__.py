from repro_torch.configs.base import (  # noqa: F401
    ARCH_NAMES, ModelConfig, MoEConfig, SSMConfig, get, torch_dtype)
