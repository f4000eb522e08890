"""The metrics registry: one namespace of typed metrics, one export format
(copied from ``repro/obs/registry.py`` without the device-resident series).

Every instrumented component takes ``metrics=`` and defaults to a private
registry; ``export()`` is the schema-versioned wire format (``repro.obs/1``,
the reference's, so both packages' exports read the same).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Metric

SCHEMA = "repro.obs/1"


class MetricsRegistry:
    """Name -> metric, get-or-create with kind checking."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, *args, **kw) -> Any:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args, **kw)
        elif type(m) is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, buckets, help)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def drain(self) -> None:
        """Fold every device-resident accumulator into its host value —
        the flush-boundary call.  Idempotent."""
        for m in self._metrics.values():
            m.drain()

    def export(self, drain: bool = True) -> Dict[str, Any]:
        """Schema-versioned snapshot of every series."""
        if drain:
            self.drain()
        rows: List[Dict[str, Any]] = []
        for name in sorted(self._metrics):
            rows.extend(self._metrics[name].rows())
        return {"schema": SCHEMA, "metrics": rows}


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


def set_default_registry(reg: Optional[MetricsRegistry]) -> None:
    """Swap the process-wide registry (tests inject a fresh one)."""
    global _DEFAULT
    _DEFAULT = reg
