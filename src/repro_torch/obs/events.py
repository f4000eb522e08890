"""Structured event log: a bounded ring buffer of schema-versioned records.

Everything that used to be an ad-hoc tuple list — scheduler
admit/retire/reject audits, supervisor health transitions and fault
sightings, checkpoint save/restore — lands here as one record shape:

    {"schema_v": 1, "seq": 17, "t": 0.031, "kind": "admit",
     "fields": {"slot": 2, "req": 5}}

``seq`` is monotone across the log's lifetime (records evicted by the ring
bound keep their numbers, so ``dropped`` is always ``seq_end - len``).
``clock`` is injectable (``resilience.FakeClock`` pattern) so event
timestamps are deterministic in tests.  The legacy tuple lists
(``Scheduler.events``, ``SupervisedExecutor.events``) are kept untouched —
the event log is an additional, unified consumer-facing stream.

``default_log()`` is the process-wide instance module-level emitters use
(``checkpoint.checkpoint``); components take ``event_log=`` to inject an
isolated one.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SCHEMA_V = 1

# the record vocabulary (schema_v 1); emitters must pick from this list so
# consumers can switch on ``kind`` without scraping free text
EVENT_KINDS = (
    "admit", "retire", "reject",                       # scheduler audits
    "health", "fault", "recover", "give_up",           # supervisor
    "checkpoint_save", "checkpoint_restore",           # checkpoint
    "generate_begin", "generate_end",                  # engine lifecycle
)


@dataclass(frozen=True)
class Event:
    """One structured record."""
    seq: int
    t: float
    kind: str
    fields: Dict[str, Any] = field(default_factory=dict)

    def row(self) -> Dict[str, Any]:
        return {"schema_v": SCHEMA_V, "seq": self.seq, "t": self.t,
                "kind": self.kind, "fields": dict(self.fields)}


class EventLog:
    """Bounded ring buffer of ``Event``s."""

    def __init__(self, capacity: int = 4096, clock=None):
        if capacity <= 0:
            raise ValueError("EventLog capacity must be positive")
        self.capacity = capacity
        self._clock = clock or time.monotonic
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0

    def emit(self, kind: str, **fields) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r} "
                             f"(schema_v {SCHEMA_V} kinds: {EVENT_KINDS})")
        ev = Event(seq=self._seq, t=float(self._clock()), kind=kind,
                   fields=fields)
        self._seq += 1
        self._buf.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        """Records evicted by the ring bound."""
        return self._seq - len(self._buf)

    def records(self, kind: Optional[str] = None) -> List[Event]:
        if kind is None:
            return list(self._buf)
        return [e for e in self._buf if e.kind == kind]

    def rows(self) -> List[Dict[str, Any]]:
        return [e.row() for e in self._buf]

    def clear(self) -> None:
        self._buf.clear()


_DEFAULT: Optional[EventLog] = None


def default_log() -> EventLog:
    """The process-wide event log (created on first use)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = EventLog()
    return _DEFAULT


def set_default_log(log: Optional[EventLog]) -> None:
    """Swap the process-wide log (tests inject a fresh one)."""
    global _DEFAULT
    _DEFAULT = log
