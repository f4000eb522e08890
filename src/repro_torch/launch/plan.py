"""Emit the auto-partitioner's search report: ``results/PLAN_7.json``
(counterpart of ``repro/launch/plan.py``, same schema).

For every arch (plus the paper's own MLP) this solves the balanced K-way
cut under the ``repro_torch.plan`` cost model and records the chosen
bounds, the uniform split for comparison, predicted per-stage bytes/FLOPs,
imbalance ratios, and the rejected search frontier.

Pure planning: the cost tables read the param trees on the meta device,
so no weight is made and no card is needed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.plan --stages 4
  PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen2-1.5b \\
      --stages 4 --assert-nonuniform      # CI gate on the searched cut
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.configs import ARCH_NAMES, get

SCHEMA = 1


def pick_optimizer_name(cfg) -> str:
    """Memory-aware default: Adafactor for >=50B-param models (the
    reference launcher's rule)."""
    return "adafactor" if cfg.param_counts()["total"] > 50e9 else "adamw"


def arch_report(arch: str, n_stages: int, *, objective: str = "bytes"
                ) -> dict:
    """One arch's PLAN_7 record; K is clamped to the unit count (an arch
    with fewer groups than requested stages still gets a valid plan)."""
    from repro_torch import plan as plan_lib
    if arch == "paper_mlp":
        from repro_torch.configs import paper_mlp
        cfg = paper_mlp.CONFIG
        table = plan_lib.mlp_costs(cfg)
        optimizer = "sgdm"           # the paper's own training setup
    else:
        cfg = get(arch)
        optimizer = pick_optimizer_name(cfg)
        table = plan_lib.lm_costs(cfg, optimizer=optimizer)
    k = min(n_stages, table.n_units)
    rep = plan_lib.plan_report(cfg, k, optimizer=optimizer,
                               objective=objective)
    rep["arch"] = arch               # CLI name (cfg.name may differ)
    if k != n_stages:
        rep["n_stages_requested"] = n_stages
    return rep


def check_nonuniform(rep: dict) -> list:
    """CI assertions on one arch's record: the searched cut must be a
    valid partition, never worse than uniform, and actually non-uniform
    (the searcher found structure to exploit)."""
    errs = []
    bounds = [tuple(b) for b in rep["auto"]["bounds"]]
    n, k = rep["n_units"], rep["n_stages"]
    if len(bounds) != k:
        errs.append(f"{len(bounds)} stages != requested {k}")
    lo = 0
    for b_lo, b_hi in bounds:
        if b_lo != lo or b_hi <= b_lo:
            errs.append(f"bounds {bounds} are not a contiguous partition")
            break
        lo = b_hi
    else:
        if lo != n:
            errs.append(f"bounds {bounds} do not cover {n} units")
    if not rep["auto_le_uniform"]:
        errs.append("searched bottleneck exceeds the uniform split's")
    if rep["auto"]["cuts"] == rep["uniform"]["cuts"] and k > 1:
        errs.append("searched cut degenerated to the uniform split")
    return [f"{rep['arch']}: {e}" for e in errs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    choices=ARCH_NAMES + ["all", "paper_mlp"])
    ap.add_argument("--stages", default="4",
                    help="stage count K (plain N or 'auto:K' -- this CLI "
                         "always searches)")
    ap.add_argument("--objective", default="bytes",
                    choices=["bytes", "flops"])
    ap.add_argument("--out", default="results/PLAN_7.json")
    ap.add_argument("--assert-nonuniform", action="store_true",
                    help="exit 1 unless every reported arch's searched cut "
                         "is valid, non-uniform, and <= uniform bottleneck")
    args = ap.parse_args(argv)

    from repro_torch.plan import parse_stages
    _, n_stages = parse_stages(args.stages)
    archs = (ARCH_NAMES + ["paper_mlp"]) if args.arch == "all" \
        else [args.arch]

    report = {"schema": SCHEMA, "tool": "repro_torch.launch.plan",
              "objective": args.objective, "n_stages": n_stages,
              "archs": {}}
    failures = []
    for arch in archs:
        rep = arch_report(arch, n_stages, objective=args.objective)
        report["archs"][arch] = rep
        auto, uni = rep["auto"], rep["uniform"]
        print(f"{arch}: K={rep['n_stages']} units={rep['n_units']} "
              f"cuts {auto['cuts']} (uniform {uni['cuts']}) "
              f"imbalance {auto['imbalance']:.4f} "
              f"(uniform {uni['imbalance']:.4f}) "
              f"auto<=uniform={rep['auto_le_uniform']}")
        if args.assert_nonuniform:
            failures += check_nonuniform(rep)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out} ({len(report['archs'])} archs)")

    for msg in failures:
        print(f"ASSERT FAILED {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
