"""Conformance sweep CLI: run the ``repro_torch.verify`` oracle registry and
emit a machine-readable report (counterpart of ``repro/launch/verify.py``:
the same flags and exit codes, plus ``--device``).

Every registered equivalence contract (kernel == plain version, concurrent
== sequential, batched == sequential decode, bf16 ~= fp32, resume ==
uninterrupted, recovered == fault-free, staged == joined, paper parity)
runs under one (preset, arch, device) context; arch-aware oracles sweep
any ``repro_torch.configs`` entry.

Runs on the card by default (``--device cuda`` raises when torch sees no
CUDA device); ``--device cpu`` runs the plain PyTorch paths.  The report
goes to ``results/CONFORMANCE_torch.json`` unless ``--json`` says
otherwise; the reference's ``results/CONFORMANCE_5.json`` is its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.verify --preset tiny \\
      [--arch qwen2-1.5b] [--only serve] [--tags kernel,serve] [--list] \\
      [--device cuda|cpu] [--json results/CONFORMANCE_torch.json]

Exit status is non-zero when any oracle fails (2 when no oracle matches
the filter).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ARCH_NAMES
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.verify import Context, all_oracles, run_oracle, write_report
from repro_torch.verify.oracle import PRESETS

DEFAULT_JSON = "results/CONFORMANCE_torch.json"


def sweep(oracles, *, preset: str, arch: str, device) -> list:
    """Run ``oracles`` under one (preset, arch, device) context, printing
    one line an oracle (and a failure's detail); returns the
    ``OracleResult``s in order."""
    results = []
    for o in oracles:
        res = run_oracle(o, Context(preset=preset, arch=arch, device=device))
        results.append(res)
        status = "PASS" if res.ok else "FAIL"
        line = f"[{status}] {o.name:38s} {res.seconds:7.1f}s"
        if res.verdict is not None and res.verdict.metrics:
            interesting = {k: v for k, v in res.verdict.metrics.items()
                           if k in ("max_abs_err", "gap", "n_tokens",
                                    "n_leaves", "n_sequences")}
            if interesting:
                line += "  " + " ".join(
                    f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in interesting.items())
        print(line, flush=True)
        if not res.ok:
            print("  " + (res.error or res.verdict.detail).strip()
                  .replace("\n", "\n  "), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sweep the repro_torch.verify conformance oracles")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_NAMES,
                    help="repro_torch.configs entry for arch-aware oracles "
                         "(serve / LM-train contracts)")
    ap.add_argument("--only", default=None,
                    help="substring filter on oracle names")
    ap.add_argument("--tags", default=None,
                    help="comma-separated tag filter (kernel, train, "
                         "serve, dist, precision, checkpoint, resilience, "
                         "plan, paper)")
    ap.add_argument("--list", action="store_true",
                    help="list matching oracles and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where both paths of every oracle run")
    ap.add_argument("--json", default=DEFAULT_JSON,
                    help="conformance report path ('' disables)")
    args = ap.parse_args(argv)

    oracles = all_oracles(tags=args.tags.split(",") if args.tags else None)
    if args.only:
        oracles = [o for o in oracles if args.only in o.name]
    if not oracles:
        print("no oracles match the filter", file=sys.stderr)
        return 2
    if args.list:
        for o in oracles:
            arch = " [arch-aware]" if o.arch_aware else ""
            print(f"{o.name:38s} tags={','.join(o.tags)}{arch}")
            print(f"  {o.contract}")
        return 0

    device = resolve_device(args.device)
    print(f"# repro_torch.verify sweep: preset={args.preset} "
          f"arch={args.arch} device={device} ({len(oracles)} oracles)")
    results = sweep(oracles, preset=args.preset, arch=args.arch,
                    device=device)
    n_failed = sum(not r.ok for r in results)
    print(f"# {len(results) - n_failed}/{len(results)} oracles passed")
    if args.json:
        write_report(args.json, results, preset=args.preset, arch=args.arch,
                     extra={"device": str(device)})
        print(f"# wrote {args.json}")
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
