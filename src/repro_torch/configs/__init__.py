from repro_torch.configs.base import (  # noqa: F401
    ARCH_NAMES, ModelConfig, get, torch_dtype)
