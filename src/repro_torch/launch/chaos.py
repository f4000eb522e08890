"""Chaos sweep CLI: drive the fault matrix through the supervised executor
and report every cell (counterpart of ``repro/launch/chaos.py``: the same
cells, schema, flags and exit codes, plus ``--device``).

Each cell injects one fault family (or a seeded mixed schedule) into a
2-stage EMNIST-like run of the paper's 784-80-60-60-60-47 MLP under
``resilience.SupervisedExecutor`` and checks the recovery guarantee that
applies:

* crash / transient / ckpt_corruption / straggler / mixed — the recovered
  run must be **bitwise equal** to the fault-free reference (the paper's
  zero-communication property makes per-stage replay exact).
* nan — the step guard must skip exactly the poisoned steps and leave the
  final params finite (a skipped step is *absent*, not approximated, so
  there is no fault-free twin to compare against).

Time is a ``FakeClock`` everywhere: backoff and straggler delays advance a
counter, so the whole matrix is deterministic and fast.  Params and SIL
tables come from ``torch.Generator``s seeded 0 and 3 on the CPU, placed
on ``--device``: the card by default (raising when torch sees none),
``--device cpu`` for the plain PyTorch path.  The report goes to
``results/RESILIENCE_torch.json`` unless ``--json`` says otherwise; the
reference's ``results/RESILIENCE_8.json`` is its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.chaos --preset tiny \\
      [--seed 0] [--device cuda|cpu] [--json results/RESILIENCE_torch.json]

Exit status is non-zero when any cell has an unrecovered fault or a failed
equivalence.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.tree import tree_leaves

SCHEMA = "repro.resilience/1"
DEFAULT_JSON = "results/RESILIENCE_torch.json"

TINY = {"n_ticks": 3, "n_train": 256, "batch_size": 64, "mixed_seeds": (0,)}
FULL = {"n_ticks": 6, "n_train": 1024, "batch_size": 128,
        "mixed_seeds": (0, 1, 2)}
PRESETS = {"tiny": TINY, "full": FULL}


def _world(preset: dict, device, *, nan_guard: bool = False):
    """(backend, stage_params, sils, hps, spec) for the 2-stage cell setup —
    identical across cells so the fault is the only variable."""
    from dataclasses import replace

    from repro_torch.models import mlp as MLP
    from repro_torch.train.backends import MLPBackend, balanced_bounds
    from repro_torch.verify import scenarios
    cfg, data, spec = scenarios.tiny_mlp(
        n_stages=2, epochs=(preset["n_ticks"],) * 2,
        n_train=preset["n_train"], batch_size=preset["batch_size"])
    if nan_guard:
        spec = replace(spec, nan_guard=True)
    be = MLPBackend(cfg, data, spec, bounds=balanced_bounds(cfg, 2),
                    device=device)
    params = MLP.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    sils = be.make_sils(torch.Generator().manual_seed(3), spec.kappa)
    hps = [spec.stage(k) for k in range(2)]
    return be, be.split(params), sils, hps, spec


def _executor(world, root):
    from repro_torch.dist import placement
    from repro_torch.dist.executor import StageExecutor
    from repro_torch.train.backends import make_optimizer_for
    be, sp0, sils, hps, spec = world
    opts = [make_optimizer_for(hp, spec) for hp in hps]
    return StageExecutor(be, placement.round_robin(2, [be.device]), sp0,
                         sils, opts, hps, shuffle=True, ckpt_dir=root)


def _bitwise_equal(a, b) -> bool:
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _cell_schedules(preset: dict, seed: int):
    """The fault matrix: (cell name, schedule, needs nan_guard)."""
    from repro_torch.resilience import (CheckpointCorruption, FaultSchedule,
                                        NaNInjection, StageCrash,
                                        StragglerDelay, TransientError)
    n_ticks = preset["n_ticks"]
    mid = max(1, n_ticks // 2)
    cells = [
        ("crash", FaultSchedule([StageCrash(stage=1, tick=mid)]), False),
        ("transient", FaultSchedule(
            [TransientError(stage=0, tick=1, failures=2)]), False),
        ("ckpt_corruption/truncate_manifest", FaultSchedule(
            [CheckpointCorruption(stage=0, tick=mid,
                                  mode="truncate_manifest")]), False),
        ("ckpt_corruption/truncate_npz", FaultSchedule(
            [CheckpointCorruption(stage=1, tick=mid,
                                  mode="truncate_npz")]), False),
        ("ckpt_corruption/flip_bytes", FaultSchedule(
            [CheckpointCorruption(stage=0, tick=mid,
                                  mode="flip_bytes")]), False),
        ("straggler", FaultSchedule(
            [StragglerDelay(stage=1, tick=1, delay=1.5)]), False),
        # both on stage 0: MLP stages k>0 take sil_lookup(sils[k-1], y) as
        # input (int labels), so a poisoned float x never reaches them
        ("nan", FaultSchedule(
            [NaNInjection(stage=0, tick=1),
             NaNInjection(stage=0, tick=2, value=float("nan"))]), True),
    ]
    for s in preset["mixed_seeds"]:
        # mixed schedules stay bitwise-comparable: nan is excluded because
        # a guarded skip has no fault-free twin (it gets its own cell)
        cells.append((f"mixed/seed{seed + s}", FaultSchedule.sample(
            seed + s, n_stages=2, n_ticks=n_ticks, n_faults=3,
            kinds=("crash", "transient", "ckpt_corruption", "straggler")),
            False))
    return cells


def run_matrix(preset_name: str, seed: int, workdir: str,
               device="cuda") -> dict:
    from repro_torch.optim import read_skipped
    from repro_torch.resilience import (FakeClock, RetryPolicy,
                                        SupervisedExecutor)
    from repro_torch.verify.report import env
    device = resolve_device(device)
    preset = PRESETS[preset_name]
    n_ticks = preset["n_ticks"]

    world = _world(preset, device)
    ref_ex = _executor(world, os.path.join(workdir, "ref"))
    ref_ex.run(n_ticks)
    ref = ref_ex.gather()

    cells = []
    for name, schedule, needs_guard in _cell_schedules(preset, seed):
        t0 = time.perf_counter()
        w = _world(preset, device, nan_guard=True) if needs_guard else world
        root = os.path.join(workdir, name.replace("/", "_"))
        ex = _executor(w, root)
        clk = FakeClock()
        sup = SupervisedExecutor(ex, schedule=schedule, clock=clk.monotonic,
                                 sleep=clk.sleep, ckpt_every=1,
                                 policy=RetryPolicy(max_retries=5, seed=seed),
                                 strict=False)
        sup.run(n_ticks)
        got = ex.gather()
        report = sup.report()
        if needs_guard:
            skipped = sum(int(read_skipped(o)) for o in ex.opt_states)
            n_inject = len(schedule.faults)
            finite = all(bool(torch.isfinite(leaf).all())
                         for leaf in tree_leaves(got))
            ok = (skipped == n_inject and finite and not sup.unrecovered)
            equivalence = "skip-count"
            detail = {"skipped": skipped, "expected": n_inject,
                      "finite": finite}
        else:
            equal = _bitwise_equal(ref, got)
            ok = equal and not sup.unrecovered and not report["never_fired"]
            equivalence = "bitwise-vs-fault-free"
            detail = {"bitwise_equal": equal}
        cells.append({
            "cell": name,
            "ok": bool(ok),
            "equivalence": equivalence,
            "faults": schedule.describe(),
            "faults_seen": report["faults_seen"],
            "unrecovered": report["unrecovered"],
            "never_fired": report["never_fired"],
            "final_ticks": report["ticks"],
            "seconds": time.perf_counter() - t0,
            **detail,
        })
        status = "PASS" if ok else "FAIL"
        print(f"[{status}] {name:36s} faults={len(schedule.faults)} "
              f"seen={len(report['faults_seen'])} "
              f"unrecovered={len(report['unrecovered'])}")

    n_failed = sum(not c["ok"] for c in cells)
    n_unrecovered = sum(len(c["unrecovered"]) for c in cells)
    return {
        "schema": SCHEMA,
        "preset": preset_name,
        "seed": seed,
        "device": str(device),
        "env": env(),
        "n_ticks": n_ticks,
        "n_cells": len(cells),
        "n_passed": len(cells) - n_failed,
        "n_failed": n_failed,
        "n_unrecovered_faults": n_unrecovered,
        "cells": cells,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sweep the resilience fault matrix through the "
                    "supervised executor")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed for the sampled mixed schedules")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the stages train")
    ap.add_argument("--json", default=DEFAULT_JSON,
                    help="report path ('' disables)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(f"# repro_torch.resilience chaos sweep: preset={args.preset} "
          f"seed={args.seed} device={device}")
    with tempfile.TemporaryDirectory(prefix="chaos_") as workdir:
        report = run_matrix(args.preset, args.seed, workdir, device)
    print(f"# {report['n_passed']}/{report['n_cells']} cells passed, "
          f"{report['n_unrecovered_faults']} unrecovered faults")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote {args.json}")
    return 1 if (report["n_failed"] or report["n_unrecovered_faults"]) else 0


if __name__ == "__main__":
    sys.exit(main())
