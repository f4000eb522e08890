"""Span timelines exportable as Chrome trace-event JSON (Perfetto/about:
tracing loadable).

A ``Tracer`` collects completed ``Span``s — host-walltime intervals on
integer tracks (``tid``s).  Three ways in:

* ``with tracer.span("tick 3", cat="stage", tid=1, stage=0):`` — timed
  around a block (the executor wraps each stage's tick *dispatch*; on an
  accelerator that is dispatch latency, not device compute — the span
  marks when work was issued and in what order).
* ``tracer.add_span(name, ts, dur, ...)`` — retroactive, for lifecycle
  spans whose start was recorded earlier (the engine's queued/active
  request spans).
* ``tracer.instant(name, ...)`` — zero-duration markers (retirements).

Track convention (one Perfetto row each): tid 0 = the driving loop
(trainer phases / engine admit+decode), tid 1+k = stage k of a
``StageExecutor``, tid 1000+i = request i's lifecycle.

``clock`` is injectable (``resilience.FakeClock`` pattern) so span
nesting/ordering is deterministic under test.  The span list is bounded:
past ``capacity`` new spans are counted in ``dropped`` and discarded —
a tracer must never become the memory leak it is meant to find.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# track-id convention (see module docstring)
TID_LOOP = 0
TID_STAGE0 = 1          # stage k -> TID_STAGE0 + k
TID_REQ0 = 1000         # request i -> TID_REQ0 + i


@dataclass(frozen=True)
class Span:
    name: str
    ts: float              # start, seconds on the tracer's clock
    dur: float             # seconds
    cat: str = ""
    tid: int = TID_LOOP
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Tracer:
    def __init__(self, clock=None, capacity: int = 100_000,
                 pid: int = 0):
        self._clock = clock or time.monotonic
        self.capacity = capacity
        self.pid = pid
        self.spans: List[Span] = []
        self.dropped = 0

    def now(self) -> float:
        return float(self._clock())

    def add_span(self, name: str, ts: float, dur: float, *, cat: str = "",
                 tid: int = TID_LOOP, **args) -> None:
        if len(self.spans) >= self.capacity:
            self.dropped += 1
            return
        self.spans.append(Span(name=name, ts=float(ts),
                               dur=max(0.0, float(dur)), cat=cat, tid=tid,
                               args=args))

    @contextmanager
    def span(self, name: str, *, cat: str = "", tid: int = TID_LOOP,
             **args):
        t0 = self.now()
        try:
            yield
        finally:
            self.add_span(name, t0, self.now() - t0, cat=cat, tid=tid,
                          **args)

    def instant(self, name: str, *, ts: Optional[float] = None,
                cat: str = "", tid: int = TID_LOOP, **args) -> None:
        self.add_span(name, self.now() if ts is None else ts, 0.0, cat=cat,
                      tid=tid, **args)

    # -- consumption --------------------------------------------------------

    def by_tid(self) -> Dict[int, List[Span]]:
        out: Dict[int, List[Span]] = {}
        for s in self.spans:
            out.setdefault(s.tid, []).append(s)
        for spans in out.values():
            spans.sort(key=lambda s: (s.ts, -s.dur))
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (ts/dur in microseconds, "X" complete
        events; instants are "i").  Load in Perfetto or chrome://tracing."""
        events = []
        for s in self.spans:
            ev: Dict[str, Any] = {
                "name": s.name, "cat": s.cat or "repro", "pid": self.pid,
                "tid": s.tid, "ts": s.ts * 1e6, "args": dict(s.args),
            }
            if s.dur > 0.0:
                ev["ph"] = "X"
                ev["dur"] = s.dur * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"      # thread-scoped instant
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
