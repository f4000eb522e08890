"""The paper-parity experiment runner (counterpart of
``repro/verify/paper.py``): the port's end-to-end reproduction gate.

The paper's central claim (§3-§5): a 6-layer fully-connected network on
EMNIST-balanced, cut into two partitions after the second hidden layer and
trained with synthetic intermediate labels (left vs SIL, one boundary
materialization, right on stored activations, §5 recovery), reaches testing
accuracy similar to conventional end-to-end training at a fraction of the
compute.  This module runs exactly that comparison through
``repro_torch.train`` and measures the accuracy gap against the preset's
budget:

* ``tiny`` -- reduced data and epochs (28,200 samples).
* ``full`` -- the paper's own sizes (112,800 samples, N_L=5, N_R=160,
  N_B=40, 10 recovery epochs), budget 0.02.

The params and SIL tables come from ``torch.Generator``s seeded with
``seed`` (baseline) and ``seed + 1`` (PNN), on the CPU, so the card and the
CPU start from the same weights.  Runs on the card by default.

CLI:  PYTHONPATH=src python -m repro_torch.verify.paper --preset tiny \\
          [--device cuda|cpu] [--seed 0] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import asdict, dataclass
from typing import Optional

import torch

from repro_torch.data.images import emnist_like
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.mlp import MLPConfig
from repro_torch.obs.trace import Tracer
from repro_torch.train import recipes
from repro_torch.verify.compare import AccuracyGap


@dataclass(frozen=True)
class PaperPreset:
    """One fidelity level of the paper's EMNIST experiment."""
    n_train: int
    n_test: int
    noise: float
    n_left: int          # N_L: left-partition epochs vs SIL
    n_right: int         # N_R: right-partition epochs on the boundary
    n_baseline: int      # N_B: conventional end-to-end epochs
    n_recovery: int      # §5 recovery epochs (stage 0, rest frozen)
    lr_recovery: float   # §5 recovery learning rate
    budget: float        # |acc_baseline - acc_pnn| ceiling
    floor: float         # baseline must at least reach this (learned at all)


# the reference's presets, value for value
PRESETS = {
    "tiny": PaperPreset(n_train=28200, n_test=2820, noise=0.5,
                        n_left=5, n_right=80, n_baseline=40, n_recovery=20,
                        lr_recovery=3e-4, budget=0.05, floor=0.60),
    "full": PaperPreset(n_train=112800, n_test=18800, noise=0.5,
                        n_left=5, n_right=160, n_baseline=40, n_recovery=10,
                        lr_recovery=3e-4, budget=0.02, floor=0.70),
}


def gap_policy(preset: str) -> AccuracyGap:
    p = PRESETS[preset]
    return AccuracyGap(budget=p.budget, floor=p.floor)


def run_paper_parity(preset: str = "tiny", *, device="cuda", seed: int = 0,
                     eval_every: int = 1000,
                     tracer: Optional[Tracer] = None) -> dict:
    """Run baseline vs PNN (Fig. 3 + §5) on ``device`` and measure the
    accuracy gap.  Returns a report dict; ``ok`` is the paper's claim
    verdict at the preset's budget.  ``tracer`` receives one span per
    training phase of both runs."""
    device = resolve_device(device)
    p = PRESETS[preset]
    cfg = MLPConfig()                      # the paper's exact 6-layer net
    # the synthetic stand-in, always: the budgets are calibrated on it
    data = emnist_like(n_train=p.n_train, n_test=p.n_test, seed=seed,
                       noise=p.noise)
    spec = recipes.paper_spec(n_left=p.n_left, n_right=p.n_right,
                              n_baseline=p.n_baseline,
                              n_recovery=p.n_recovery,
                              lr_recovery=p.lr_recovery)
    t0 = time.perf_counter()
    _, hist_b = recipes.run_mlp_baseline(
        cfg, data, spec, torch.Generator().manual_seed(seed),
        eval_every=eval_every, device=device, tracer=tracer)
    t_base = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, hist_p = recipes.run_mlp_fig3(
        cfg, data, spec, torch.Generator().manual_seed(seed + 1),
        eval_every=eval_every, device=device, tracer=tracer)
    t_pnn = time.perf_counter() - t0

    acc_b, acc_p = hist_b.column("acc")[-1], hist_p.column("acc")[-1]
    macs_b, macs_p = hist_b.column("macs")[-1], hist_p.column("macs")[-1]
    losses = hist_b.column("loss") + hist_p.column("loss")
    steps = {}
    for r in hist_b.records + hist_p.records:
        if r.loss is not None:
            steps[r.phase] = steps.get(r.phase, 0) + 1
    verdict = gap_policy(preset).compare(acc_b, acc_p)
    return {
        "preset": preset,
        "device": str(device),
        "config": asdict(p),
        "baseline_acc": float(acc_b),
        "pnn_acc": float(acc_p),
        "gap": abs(float(acc_b) - float(acc_p)),
        "budget": p.budget,
        "floor": p.floor,
        "ok": verdict.ok,
        "detail": verdict.detail,
        # the paper's efficiency axis: cumulative per-sample MACs
        "baseline_macs": int(macs_b),
        "pnn_macs": int(macs_p),
        "macs_ratio": float(macs_p) / float(macs_b),
        "n_steps": len(losses),
        "steps_by_phase": steps,
        "losses_finite": all(v == v and abs(v) != float("inf")
                             for v in losses),
        "seconds": {"baseline": t_base, "pnn": t_pnn},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="paper-parity gate: PNN vs conventional training on "
                    "the EMNIST 6-layer / 2-partition experiment")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="also write the report to this path")
    args = ap.parse_args(argv)

    res = run_paper_parity(args.preset, device=args.device, seed=args.seed)
    status = "PASS" if res["ok"] else "FAIL"
    print(f"[{status}] paper parity ({args.preset}, {res['device']}): "
          f"baseline={res['baseline_acc']:.4f} pnn={res['pnn_acc']:.4f} "
          f"gap={res['gap']:.4f} (budget {res['budget']}) "
          f"macs_ratio={res['macs_ratio']:.2f}")
    if not res["ok"]:
        print("  " + res["detail"])
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.json}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
