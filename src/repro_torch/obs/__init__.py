"""repro_torch.obs — host-side observability: metrics, structured events,
spans (the host-only parts of ``repro.obs``)."""
from repro_torch.obs.events import (EVENT_KINDS, Event, EventLog, default_log,
                                    set_default_log)
from repro_torch.obs.metrics import (DEPTH_BUCKETS, LOSS_BUCKETS,
                                     TTFT_MS_BUCKETS, Counter, Gauge,
                                     Histogram)
from repro_torch.obs.registry import (SCHEMA, MetricsRegistry,
                                      default_registry, set_default_registry)
from repro_torch.obs.trace import TID_LOOP, TID_REQ0, TID_STAGE0, Span, Tracer

__all__ = [
    "SCHEMA", "EVENT_KINDS", "TTFT_MS_BUCKETS", "LOSS_BUCKETS",
    "DEPTH_BUCKETS", "TID_LOOP", "TID_STAGE0", "TID_REQ0",
    "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "default_registry", "set_default_registry",
    "Event", "EventLog", "default_log", "set_default_log",
    "Span", "Tracer",
]
