"""Self-healing stage execution: ``SupervisedExecutor`` (counterpart of
``repro/resilience/supervisor.py``).

Wraps ``repro_torch.dist.StageExecutor`` with per-stage health tracking,
bounded retry with exponential backoff + jitter, and automatic
checkpoint-based recovery.  The paper's zero-inter-stage-communication
property is what makes this cheap: a dead stage is restored from its OWN
last valid checkpoint and replays its OWN lost ticks — no other stage rolls
back, no other stage even pauses (contrast pipeline parallelism, where
failure and communication domains coincide and one rank's death stalls the
world).

Correctness contract, pinned by the ``resilience/crash_equivalence``
oracle: because each stage's data access is deterministic by tick index
and the executor's metrics high-water mark suppresses replayed logging, a
run that crashes and recovers finishes **bitwise identical** to the
fault-free run.

The supervisor is host-side control plane by construction — it decides
*whether* to dispatch a tick, never touches the math inside one.  Its host
syncs (restoring checkpoints, which copy to the device, and saving them,
which copy to the host) sit between ticks.

On the card a CUDA error is reported asynchronously, at a later sync, and
a sticky one (an illegal address) poisons the context for good: retrying
such a tick cannot succeed.  The real-failure path (``except Exception``
around ``tick``) is kept as the reference has it, for the errors that do
surface at the launch (a wrapper's shape check, an allocation that fails);
a caller that needs recovery to be exact checks that no ``("error", ...)``
fault was seen.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from repro_torch.obs.events import EventLog, default_log
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.resilience.faults import FaultSchedule, apply_corruption
from repro_torch.tree import tree_map


class UnrecoveredFaultError(RuntimeError):
    """A stage exhausted its retry budget (or has no checkpoint to recover
    from) — the supervised run cannot reach the fault-free result."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic seeded jitter.

    Delay for attempt a (0-based) is ``base * factor**a * (1 + jitter*u)``
    with ``u ~ U[0,1)`` from a dedicated ``random.Random(seed)`` stream —
    replayable, and never synchronized across stages (each stage draws from
    its own offset seed, so two stages failing together don't retry in
    lockstep and re-collide)."""
    max_retries: int = 3
    base: float = 0.05
    factor: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delays(self, stage: int):
        rng = random.Random(self.seed * 1_000_003 + stage)
        for a in range(self.max_retries):
            yield self.base * (self.factor ** a) \
                * (1.0 + self.jitter * rng.random())


class StageHealth:
    """One stage's control-plane state machine:
    ok -> retrying -> (recovering ->) ok, or -> failed."""
    OK = "ok"
    RETRYING = "retrying"        # backoff armed, live state intact
    RECOVERING = "recovering"    # backoff armed, live state LOST
    FAILED = "failed"            # retry budget exhausted

    def __init__(self, stage: int, policy: RetryPolicy):
        self.stage = stage
        self.state = self.OK
        self.attempts = 0
        self.retry_at = 0.0
        self._delays = policy.delays(stage)
        self._policy = policy

    def arm_retry(self, now: float, *, lost_state: bool) -> bool:
        """Move to retrying/recovering with the next backoff delay armed;
        False when the retry budget is exhausted (-> FAILED)."""
        try:
            delay = next(self._delays)
        except StopIteration:
            self.state = self.FAILED
            return False
        self.attempts += 1
        self.retry_at = now + delay
        if lost_state or self.state == self.RECOVERING:
            # once live state is lost it stays lost until a restore succeeds
            self.state = self.RECOVERING
        else:
            self.state = self.RETRYING
        return True

    def healthy(self) -> None:
        self.state = self.OK
        self.attempts = 0
        self.retry_at = 0.0
        self._delays = self._policy.delays(self.stage)


class SupervisedExecutor:
    """Drives a ``StageExecutor`` tick-by-tick under (injected or real)
    faults, keeping surviving stages on schedule while broken ones back
    off, restore, and replay.

    ``schedule``: a ``FaultSchedule`` consulted at the dispatch seam; None
    supervises real faults only (any exception out of a stage's dispatch
    is treated as transient until the retry budget runs out, then the
    stage is restored from checkpoint like a crash).
    ``clock``/``sleep``: injectable time (see ``faults.FakeClock``) so
    backoff costs no wall time in tests.
    ``strict=True`` raises ``UnrecoveredFaultError`` on the first stage
    that cannot be brought back; ``strict=False`` records it and keeps the
    other stages running (the chaos CLI counts the wreckage)."""

    def __init__(self, executor, *, schedule: Optional[FaultSchedule] = None,
                 policy: Optional[RetryPolicy] = None, ckpt_every: int = 1,
                 clock=None, sleep=None, strict: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 event_log: Optional[EventLog] = None):
        if not executor.ckpt_dir:
            raise ValueError("SupervisedExecutor needs an executor with "
                             "ckpt_dir: recovery restores from per-stage "
                             "checkpoints")
        self.ex = executor
        self.schedule = schedule
        self.policy = policy or RetryPolicy()
        self.ckpt_every = max(1, int(ckpt_every))
        self.clock = clock or time.monotonic
        self.sleep = sleep or time.sleep
        self.strict = strict
        self.health = [StageHealth(k, self.policy)
                       for k in range(executor.n)]
        self.events: List[tuple] = []
        self.faults_seen: List[tuple] = []
        self.unrecovered: List[tuple] = []
        # observability (repro_torch.obs): fault/recover/give_up tuples
        # mirror into the structured event log; health-state flips emit
        # "health" records
        self.metrics = metrics if metrics is not None \
            else getattr(executor, "metrics", None) or MetricsRegistry()
        self.event_log = event_log if event_log is not None else default_log()
        self._faults_counter = self.metrics.counter(
            "supervisor_faults_total", help="faults seen, by kind")
        self._recoveries = self.metrics.counter(
            "supervisor_recoveries_total",
            help="successful checkpoint restores after a fault")
        self._give_ups = self.metrics.counter(
            "supervisor_give_ups_total", help="stages left unrecovered")
        if schedule is not None:
            hook = schedule.nan_batch_hook()
            if hook is not None:
                executor.batch_hook = hook

    # -- seam helpers ------------------------------------------------------

    def _emit(self, *event) -> None:
        self.events.append(event)
        kind = event[0]
        if kind == "fault":
            self.event_log.emit("fault", fault=event[1], stage=event[2],
                                tick=event[3])
            self._faults_counter.inc(1, kind=event[1])
        elif kind == "recover":
            self.event_log.emit("recover", stage=event[1], tick=event[2])
            self._recoveries.inc()
        elif kind == "give_up":
            self.event_log.emit("give_up", stage=event[1], why=event[2])
            self._give_ups.inc()
        # "tick"/"checkpoint" tuples stay legacy-only: the structured
        # checkpoint_save records come from checkpoint.checkpoint itself
        # (emitting here too would double-report every save)

    def _duration(self, k: int) -> int:
        return self.ex._duration(k)

    def _done(self, k: int) -> bool:
        return self.ex.ticks[k] >= self._duration(k) \
            or self.health[k].state == StageHealth.FAILED

    def _give_up(self, k: int, why: str) -> None:
        self.health[k].state = StageHealth.FAILED
        self.unrecovered.append((k, why))
        self._emit("give_up", k, why)
        if self.strict:
            raise UnrecoveredFaultError(
                f"stage {k} unrecovered: {why} "
                f"(events so far: {self.events[-5:]})")

    def _trash_stage(self, k: int) -> None:
        """Simulate the crash's effect: the stage's live device state is
        gone.  Zeros (not garbage) so that accidentally *using* the trashed
        state shows up as a loud bitwise mismatch, never flaky.  The step
        functions read the executor's ``params[k]`` / ``opt_states[k]`` and
        update those tensors in place, so the zero trees put there are
        exactly what the stage's next tick would train from."""
        self.ex.params[k] = tree_map(torch.zeros_like, self.ex.params[k])
        self.ex.opt_states[k] = tree_map(torch.zeros_like,
                                         self.ex.opt_states[k])

    def _try_restore(self, k: int) -> bool:
        try:
            tick = self.ex.resume_stage(k)
        except (ValueError, FileNotFoundError) as e:
            self._give_up(k, f"restore failed: {e}")
            return False
        self.health[k].healthy()
        self._emit("recover", k, tick)
        return True

    def _checkpoint_if_due(self, k: int) -> None:
        if self.ex.ticks[k] % self.ckpt_every == 0 \
                or self.ex.ticks[k] >= self._duration(k):
            self.ex.checkpoint(stages=[k])
            self._emit("checkpoint", k, self.ex.ticks[k])

    # -- the supervised loop ----------------------------------------------

    def _advance(self, k: int) -> bool:
        """One visit to stage k (see ``_advance_inner``), with the health
        state machine's transitions published as structured "health" events
        — the supervisor's own logic never reads them back."""
        before = self.health[k].state
        try:
            return self._advance_inner(k)
        finally:
            # finally: strict-mode give_up raises out of the visit, but the
            # ok->failed flip must still reach the log
            after = self.health[k].state
            if after != before:
                self.event_log.emit("health", stage=k, old=before, new=after)

    def _advance_inner(self, k: int) -> bool:
        """One visit to stage k: dispatch its next tick, or handle/arm a
        fault.  Returns True when the visit made progress (so the outer
        loop knows whether anyone is merely waiting on a clock)."""
        h = self.health[k]
        now = self.clock()
        if h.state in (StageHealth.RETRYING, StageHealth.RECOVERING):
            if now < h.retry_at:
                return False                      # still backing off
            if h.state == StageHealth.RECOVERING and not self._try_restore(k):
                return False
            # RETRYING past its deadline falls through to the dispatch
            # attempt below; health resets only on SUCCESS — resetting here
            # would hand a repeatedly-failing stage a fresh budget per round
        i = self.ex.ticks[k]
        sched = self.schedule
        if sched is not None:
            straggler = sched.straggler_at(k, i)
            if straggler is not None:
                sched.consume(straggler)
                self.faults_seen.append(("straggler", k, i))
                self._emit("fault", "straggler", k, i)
                h.state = StageHealth.RETRYING    # state intact; just late
                h.retry_at = now + straggler.delay
                return True
            corruption = sched.corruption_at(k, i)
            if corruption is not None:
                sched.consume(corruption)
                self.faults_seen.append(("ckpt_corruption", k, i))
                self._emit("fault", "ckpt_corruption", k, i)
                apply_corruption(self.ex.ckpt_dir, k, corruption.mode)
                # the write that tore also takes the writer down: lose the
                # live state so recovery MUST route around the bad file
                self._trash_stage(k)
                if not h.arm_retry(now, lost_state=True):
                    self._give_up(k, f"ckpt_corruption at tick {i}")
                return True
            crash = sched.crash_at(k, i)
            if crash is not None:
                sched.consume(crash)
                self.faults_seen.append(("crash", k, i))
                self._emit("fault", "crash", k, i)
                self._trash_stage(k)
                if not h.arm_retry(now, lost_state=True):
                    self._give_up(k, f"crash at tick {i}")
                return True
            if sched.transient_failing(k, i):
                self.faults_seen.append(("transient", k, i))
                self._emit("fault", "transient", k, i)
                if not h.arm_retry(now, lost_state=False):
                    self._give_up(k, f"transient at tick {i}")
                return True
        try:
            self.ex.tick(i, stages=[k])
        except Exception as e:                    # a REAL dispatch failure
            self.faults_seen.append(("error", k, i))
            self._emit("fault", "error", k, i, repr(e))
            if not h.arm_retry(now, lost_state=False):
                self._give_up(k, f"dispatch error at tick {i}: {e!r}")
            return True
        h.healthy()
        self._emit("tick", k, i)
        self._checkpoint_if_due(k)
        return True

    def run(self, n_ticks: Optional[int] = None,
            stages: Optional[Sequence[int]] = None) -> "SupervisedExecutor":
        """Supervised round-robin: every healthy stage advances one tick per
        round, so a stage stuck in backoff never blocks the others.  Ends
        when every stage reaches its duration (or ``n_ticks``) or is FAILED.
        """
        ks = list(range(self.ex.n)) if stages is None else list(stages)

        def target(k):
            d = self._duration(k)
            return d if n_ticks is None else min(d, n_ticks)

        # tick-0 checkpoints first: a stage that crashes on its very first
        # tick must still have a restore point
        for k in ks:
            if self.ex.ticks[k] == 0:
                self.ex.checkpoint(stages=[k])
                self._emit("checkpoint", k, 0)
        while True:
            live = [k for k in ks if self.ex.ticks[k] < target(k)
                    and self.health[k].state != StageHealth.FAILED]
            if not live:
                break
            progressed = False
            for k in live:
                progressed = self._advance(k) or progressed
            if not progressed:
                # everyone alive is waiting on a retry_at deadline — jump
                # the clock to the earliest one instead of spinning
                now = self.clock()
                wake = min(self.health[k].retry_at for k in live
                           if self.health[k].state != StageHealth.OK)
                self.sleep(max(0.0, wake - now))
        return self

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        pending = [f.describe() for f in self.schedule.unconsumed()] \
            if self.schedule else []
        return {
            "ticks": list(self.ex.ticks),
            "faults_seen": [list(f) for f in self.faults_seen],
            "unrecovered": [[k, why] for k, why in self.unrecovered],
            "never_fired": pending,
            "health": [h.state for h in self.health],
            "n_events": len(self.events),
        }
