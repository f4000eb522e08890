from .optimizers import (  # noqa: F401
    Optimizer, sgd_momentum, adamw, adafactor, make_optimizer,
    mixed_precision, step_guard, read_skipped)
from .schedules import constant, cosine_warmup  # noqa: F401
