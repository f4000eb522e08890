"""Continuous-batching scheduler: slot bookkeeping + admission control.

Pure host-side logic (the device side lives in ``kv_cache`` / ``engine``).
Slots move free -> active on ``admit`` and back on ``retire``; every
transition is audited (``events``) and checked (``_check``) so a leaked or
double-booked slot fails loudly instead of silently serving two requests
from one cache row.

The scheduler also owns the wait queue (resilience): requests enter
via ``submit`` stamped with their submission time, and ``expire_queued`` /
``overdue_active`` implement graceful degradation — a request that has
outwaited ``max_queue_wait_ms`` or its own ``deadline_ms`` is REJECTED
(audited ``("reject", req_idx)`` event) instead of leaking in a stalled
engine.  With no deadlines configured the queue is plain FIFO and the
event stream is exactly the legacy admit/retire sequence.

Observability (obs): every audited transition is mirrored into the
structured ``event_log`` exactly once, at the same site the legacy tuple
is appended — ``admit``/``retire`` records carry ``slot`` (+ ``req``),
``reject`` records carry ``req``.  The legacy ``events`` tuple list is
unchanged; tests pin the one-to-one mapping.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.events import EventLog, default_log


@dataclass
class SlotState:
    """Host-side state of one in-flight request."""
    req_idx: int                     # position in the generate() request list
    request: Any
    n_prompt: int
    emitted: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    arrival: float = 0.0             # submission time (deadline epoch)
    # physical cache block ids owned by this request (paged pool only) —
    # the engine releases them back to the BlockAllocator at retirement
    blocks: Optional[Tuple[int, ...]] = None

    @property
    def remaining(self) -> int:
        return self.request.gen.max_new_tokens - len(self.emitted)


class Scheduler:
    """Admit requests into free cache slots; retire on EOS / length;
    reject on queue timeout / missed deadline."""

    def __init__(self, n_slots: int, *,
                 max_queue_wait_ms: Optional[float] = None,
                 event_log: Optional[EventLog] = None):
        self.n_slots = n_slots
        self.max_queue_wait_ms = max_queue_wait_ms
        self.free: List[int] = list(range(n_slots))
        self.active: Dict[int, SlotState] = {}
        self.queue: Deque[Tuple[int, Any, float]] = deque()
        self.events: List[Tuple[str, int]] = []
        self.event_log = event_log if event_log is not None else default_log()
        self.max_concurrent = 0

    # -- queue -------------------------------------------------------------

    def submit(self, req_idx: int, request, now: float = 0.0) -> None:
        """Enqueue a request, stamped with its submission time — the epoch
        both the queue-wait limit and the request's own deadline count
        from."""
        self.queue.append((req_idx, request, now))

    def queued(self) -> int:
        return len(self.queue)

    def take(self, n: int,
             now: Optional[float] = None) -> List[Tuple[int, Any, float]]:
        """Pop up to ``n`` queued entries in arrival order.  With ``now``
        (open-loop traffic), only entries whose stamped submission time has
        passed are eligible — and ALL of them are scanned, not just a
        prefix: a future-stamped head (out-of-order ``submit``) must not
        starve an already-arrived entry queued behind it."""
        if now is None:
            out: List[Tuple[int, Any, float]] = []
            while self.queue and len(out) < n:
                out.append(self.queue.popleft())
            return out
        arrived = [e for e in self.queue if e[2] <= now]
        arrived.sort(key=lambda e: e[2])  # stable: FIFO within equal stamps
        out = arrived[:n]
        taken = {id(e) for e in out}
        self.queue = deque(e for e in self.queue if id(e) not in taken)
        return out

    def requeue_front(self,
                      entries: List[Tuple[int, Any, float]]) -> None:
        """Push taken entries back to the head (original order preserved) —
        used when paged-cache admission runs out of free blocks mid-batch
        and the tail of a ``take`` must wait for the next retirement."""
        for e in reversed(entries):
            self.queue.appendleft(e)

    def next_arrival(self) -> Optional[float]:
        """Earliest stamped submission time still queued (None if empty)."""
        return min((t for _, _, t in self.queue), default=None)

    def expire_queued(self, now: float) -> List[Tuple[int, Any]]:
        """Drop every queued request that has outwaited the queue limit or
        its own ``deadline_ms``; returns the rejected (req_idx, request)
        pairs (audited, in arrival order)."""
        kept: Deque[Tuple[int, Any, float]] = deque()
        rejected: List[Tuple[int, Any]] = []
        for req_idx, request, t in self.queue:
            waited_ms = (now - t) * 1000.0
            deadline = getattr(request, "deadline_ms", None)
            if (self.max_queue_wait_ms is not None
                    and waited_ms > self.max_queue_wait_ms) \
                    or (deadline is not None and waited_ms > deadline):
                rejected.append((req_idx, request))
                self.events.append(("reject", req_idx))
                self.event_log.emit("reject", req=req_idx)
            else:
                kept.append((req_idx, request, t))
        self.queue = kept
        return rejected

    def overdue_active(self, now: float) -> List[int]:
        """Slots whose request blew its ``deadline_ms`` mid-decode — the
        engine sheds these (retire with "rejected", partial tokens kept)
        so one slow request can't hold a cache slot forever."""
        return [slot for slot, st in self.active.items()
                if getattr(st.request, "deadline_ms", None) is not None
                and (now - st.arrival) * 1000.0 > st.request.deadline_ms]

    # -- slots -------------------------------------------------------------

    def admit(self, req_idx: int, request, n_prompt: int,
              arrival: float = 0.0) -> int:
        if not self.free:
            raise RuntimeError("admit() with no free slot")
        slot = self.free.pop(0)
        assert slot not in self.active, f"slot {slot} double-booked"
        self.active[slot] = SlotState(req_idx, request, n_prompt,
                                      arrival=arrival)
        self.events.append(("admit", slot))
        self.event_log.emit("admit", slot=slot, req=req_idx)
        self.max_concurrent = max(self.max_concurrent, len(self.active))
        self._check()
        return slot

    def retire(self, slot: int) -> SlotState:
        st = self.active.pop(slot)
        self.free.append(slot)
        self.events.append(("retire", slot))
        self.event_log.emit("retire", slot=slot, req=st.req_idx)
        self._check()
        return st

    def min_remaining(self) -> int:
        """Tokens until the nearest guaranteed retirement (schedules the
        fused-decode chunk length).  Returns 0 when no slot is active —
        e.g. every active slot was shed mid-tick by ``overdue_active`` —
        so the engine idles to the next arrival instead of dying on a
        ``min()`` of an empty sequence."""
        if not self.active:
            return 0
        return min(st.remaining for st in self.active.values())

    def _check(self) -> None:
        ids = sorted(self.free) + sorted(self.active)
        assert sorted(ids) == list(range(self.n_slots)), (
            f"slot leak: free={self.free} active={sorted(self.active)}")
