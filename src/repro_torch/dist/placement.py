"""Stage -> device placement plans (counterpart of
``repro/dist/placement.py``).

A ``PlacementPlan`` is the static answer to "which device trains partition
k".  Three strategies:

* ``round_robin``     -- stage k on device k mod D (the load-oblivious
                         default; exact when stages are balanced, which
                         ``partition.make_plan`` aims for).
* ``explicit``        -- a caller-chosen assignment.
* ``memory_balanced`` -- greedy largest-first packing by per-stage byte
                         estimates (params + optimizer slots,
                         ``plan.costs.estimate_stage_bytes``).

``devices`` entries are opaque to this module: ``torch.device``s in
production, any hashable stand-ins in the tests.  ``devices=None`` means
every CUDA card torch sees (``cuda:0 .. cuda:n-1``), and raises where it
sees none.  ``stage_devices(n, device)`` is the CLI's list: the first ``n``
cards, or the CPU ``n`` times (how the CPU tests place stages).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.plan.costs import estimate_stage_bytes  # noqa: F401


@dataclass(frozen=True)
class PlacementPlan:
    """``assignments[k]`` is the ordinal (into ``devices``) of the device
    that owns stage k's params, optimizer state and step."""
    assignments: Tuple[int, ...]
    devices: Tuple[Any, ...]
    strategy: str = "explicit"
    loads: Tuple[int, ...] = ()    # per-device byte estimate (memory plans)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def device_for(self, k: int):
        return self.devices[self.assignments[k]]

    def validate(self, n_stages: int) -> "PlacementPlan":
        if len(self.assignments) != n_stages:
            raise ValueError(f"plan places {len(self.assignments)} stages; "
                             f"the backend has {n_stages}")
        if not self.devices:
            raise ValueError("plan has no devices")
        bad = [a for a in self.assignments
               if not 0 <= a < len(self.devices)]
        if bad:
            raise ValueError(f"assignments {bad} out of range for "
                             f"{len(self.devices)} devices")
        return self

    def describe(self) -> str:
        per_dev = {}
        for k, a in enumerate(self.assignments):
            per_dev.setdefault(a, []).append(k)
        parts = [f"dev{a}<-stages{v}" for a, v in sorted(per_dev.items())]
        return f"{self.strategy}: " + " ".join(parts)


def _default_devices(devices):
    if devices is not None:
        return tuple(devices)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("stage placement without devices= takes the CUDA "
                           "cards, and torch sees none; pass devices= (e.g. "
                           "stage_devices(n, 'cpu'))")
    return tuple(torch.device("cuda", i) for i in range(n))


def stage_devices(n: int, device="cuda") -> Tuple[torch.device, ...]:
    """``n`` devices for a placement plan: the first ``n`` CUDA cards
    (raising if fewer are visible), or the CPU device ``n`` times."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),) * n
    if dev.type != "cuda":
        raise ValueError(f"no stage placement on {dev.type!r} devices")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise RuntimeError(f"need {n} CUDA devices, torch sees {have}")
    return tuple(torch.device("cuda", i) for i in range(n))


def round_robin(n_stages: int, devices: Optional[Sequence] = None
                ) -> PlacementPlan:
    devs = _default_devices(devices)
    return PlacementPlan(tuple(k % len(devs) for k in range(n_stages)),
                         devs, strategy="round_robin").validate(n_stages)


def explicit(assignments: Sequence[int], devices: Optional[Sequence] = None
             ) -> PlacementPlan:
    devs = _default_devices(devices)
    plan = PlacementPlan(tuple(int(a) for a in assignments), devs,
                         strategy="explicit")
    return plan.validate(len(assignments))


def memory_balanced(stage_bytes: Sequence[int],
                    devices: Optional[Sequence] = None) -> PlacementPlan:
    """Greedy bin packing: stages largest first, each onto the device with
    the least byte load so far.  Deterministic (ties break toward the lower
    stage index, then the lower device ordinal); the largest per-device
    load is never worse than round-robin's."""
    devs = _default_devices(devices)
    loads = [0] * len(devs)
    assignments = [0] * len(stage_bytes)
    order = sorted(range(len(stage_bytes)),
                   key=lambda k: (-int(stage_bytes[k]), k))
    for k in order:
        a = min(range(len(devs)), key=lambda d: (loads[d], d))
        assignments[k] = a
        loads[a] += int(stage_bytes[k])
    plan = PlacementPlan(tuple(assignments), devs, strategy="memory",
                         loads=tuple(loads))
    return plan.validate(len(stage_bytes))


def resolve(plan: Union[PlacementPlan, str, Sequence[int]], n_stages: int,
            *, devices: Optional[Sequence] = None,
            stage_bytes: Optional[Union[Sequence[int], Callable]] = None
            ) -> PlacementPlan:
    """A plan, a strategy name or an explicit assignment list -> a
    validated ``PlacementPlan``.  ``stage_bytes`` feeds ``"memory"``: a
    byte list, or a zero-argument callable giving one (run only when that
    strategy is chosen)."""
    if isinstance(plan, PlacementPlan):
        return plan.validate(n_stages)
    if plan == "round_robin":
        return round_robin(n_stages, devices)
    if plan == "memory":
        if stage_bytes is None:
            raise ValueError("memory placement needs stage_bytes")
        sizes = stage_bytes() if callable(stage_bytes) else stage_bytes
        return memory_balanced(sizes, devices)
    if isinstance(plan, (list, tuple)):
        return explicit(plan, devices)
    raise ValueError(f"unknown placement plan {plan!r}; expected a "
                     "PlacementPlan, 'round_robin', 'memory', or an "
                     "explicit assignment sequence")
