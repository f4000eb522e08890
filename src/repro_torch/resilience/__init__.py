"""``repro_torch.resilience`` — deterministic fault injection and the
self-healing stage supervisor (counterpart of ``repro.resilience``)."""
from .faults import (  # noqa: F401
    CheckpointCorruption, FakeClock, Fault, FaultSchedule, NaNInjection,
    StageCrash, StragglerDelay, TransientError)
from .supervisor import (  # noqa: F401
    RetryPolicy, StageHealth, SupervisedExecutor, UnrecoveredFaultError)
