"""Typed host metrics: ``Counter`` / ``Gauge`` / ``Histogram`` (copied from
``repro/obs/metrics.py``; the device-resident variants are not ported yet).

Histograms are **fixed-bucket**: ``edges`` define ``len(edges) + 1``
buckets — bucket 0 is ``(-inf, edges[0]]``, bucket i is
``(edges[i-1], edges[i]]``, and the last bucket is ``(edges[-1], inf)``.
``percentile(q)`` interpolates linearly inside the covering bucket, so its
error is bounded by that bucket's width.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# default bucket ladders (ms for latency, nats for losses, entities for
# depth) — log-spaced so p99 of a heavy tail still lands in a narrow bucket
TTFT_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 120000.0)
LOSS_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0,
                256.0, 4096.0)
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 512.0)


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Metric:
    """Base: one named metric holding labeled series."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def drain(self) -> None:
        """Fold any device-resident state into the host value (no-op for
        host-only metrics).  Idempotent."""

    def rows(self) -> Iterable[Dict[str, Any]]:
        raise NotImplementedError


class Counter(Metric):
    """Monotone counter with optional labels: ``c.inc(3, stage=0)``."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._series: Dict[LabelKey, int] = {}

    def inc(self, n: int = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        k = _label_key(labels)
        self._series[k] = self._series.get(k, 0) + int(n)

    def value(self, **labels) -> int:
        return self._series.get(_label_key(labels), 0)

    def total(self) -> int:
        return sum(self._series.values())

    def rows(self):
        for k, v in sorted(self._series.items()):
            yield {"name": self.name, "kind": self.kind,
                   "labels": dict(k), "value": v}


class Gauge(Metric):
    """Last-value gauge with optional labels; ``set_max`` keeps peaks."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._series: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels) -> None:
        self._series[_label_key(labels)] = float(v)

    def set_max(self, v: float, **labels) -> None:
        k = _label_key(labels)
        self._series[k] = max(self._series.get(k, float("-inf")), float(v))

    def value(self, **labels) -> Optional[float]:
        return self._series.get(_label_key(labels))

    def rows(self):
        for k, v in sorted(self._series.items()):
            yield {"name": self.name, "kind": self.kind,
                   "labels": dict(k), "value": v}


class Histogram(Metric):
    """Fixed-bucket histogram (single series)."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = ""):
        super().__init__(name, help)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be a "
                             "non-empty ascending sequence")
        self.edges: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0
        self.sum = 0.0
        self.max: Optional[float] = None
        self.min: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.total += 1
        self.sum += v
        self.max = v if self.max is None else max(self.max, v)
        self.min = v if self.min is None else min(self.min, v)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.total if self.total else None

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated percentile (None when empty).

        Error bound: the width of the covering bucket.  The open-ended
        buckets substitute the tracked extrema for their missing edge: the
        underflow bucket interpolates from ``min`` up to
        ``min(edges[0], max)`` (every observation may sit far below
        ``edges[0]`` — sub-ms TTFTs under a 1 ms first edge — so reporting
        ``edges[0]`` could exceed the true maximum), and the overflow
        bucket reports ``max``.  The estimate is always within
        ``[min, max]``."""
        if not self.total:
            return None
        target = (q / 100.0) * self.total
        cum = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                if i == len(self.edges):
                    return self.max
                if i == 0:
                    lo = self.edges[0] if self.min is None else self.min
                    hi = self.edges[0] if self.max is None \
                        else min(self.edges[0], self.max)
                else:
                    lo, hi = self.edges[i - 1], self.edges[i]
                est = lo + (hi - lo) * (target - cum) / c
                # interpolation can overshoot the tracked extrema inside
                # the covering bucket; they are tighter bounds
                if self.max is not None:
                    est = min(est, self.max)
                if self.min is not None:
                    est = max(est, self.min)
                return est
            cum += c
        return self.max

    def summary(self) -> Dict[str, Any]:
        return {"count": self.total, "sum": self.sum, "mean": self.mean,
                "max": self.max, "min": self.min,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}

    def rows(self):
        yield {"name": self.name, "kind": self.kind, "labels": {},
               "edges": list(self.edges), "counts": list(self.counts),
               **self.summary()}
