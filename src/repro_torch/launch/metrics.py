"""Metrics report CLI: dump / summarize / validate ``repro.obs/1`` reports
(counterpart of ``repro/launch/metrics.py``: the same checks, messages,
flags and exit codes).

Consumes the schema-versioned JSON that ``launch/loadgen.py`` writes
(``results/BENCH_9_torch.json``) — or any file embedding a
``MetricsRegistry.export()`` under a ``metrics`` key, the reference's
reports included: both packages write the same schema.

``--check`` is the CI gate: exit 1 on any schema violation or on empty
percentile rows (a histogram that claims observations but reports no
p50/p99 means the drain path is broken).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.metrics results/BENCH_9_torch.json
  PYTHONPATH=src python -m repro_torch.launch.metrics --dump \\
      results/BENCH_9_torch.json
  PYTHONPATH=src python -m repro_torch.launch.metrics --check \\
      results/BENCH_9_torch.json
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List

from repro_torch.obs.registry import SCHEMA

_HIST_KEYS = ("count", "p50", "p90", "p99")


def validate_report(report: Dict[str, Any]) -> List[str]:
    """All schema violations in ``report`` (empty list = valid)."""
    bad: List[str] = []
    if report.get("schema") != SCHEMA:
        bad.append(f"schema: expected {SCHEMA!r}, "
                   f"got {report.get('schema')!r}")
    rows = report.get("metrics")
    if not isinstance(rows, list) or not rows:
        bad.append("metrics: missing or empty row list")
        rows = []
    for i, row in enumerate(rows):
        where = f"metrics[{i}]"
        if not isinstance(row, dict) or "name" not in row \
                or "kind" not in row:
            bad.append(f"{where}: rows need name+kind, got {row!r}")
            continue
        where = f"metrics[{i}] ({row['name']})"
        if row["kind"] == "histogram":
            missing = [k for k in _HIST_KEYS if k not in row]
            if missing:
                bad.append(f"{where}: histogram row lacks {missing}")
            elif row["count"] and any(row[q] is None
                                      for q in ("p50", "p90", "p99")):
                bad.append(f"{where}: {row['count']} observations but "
                           "empty percentile row (drain broken?)")
        elif "value" not in row:
            bad.append(f"{where}: {row['kind']} row lacks value")
    slo = report.get("slo")
    if slo is not None:          # loadgen reports carry an SLO block
        ttft = slo.get("ttft_ms") or {}
        if not ttft.get("count"):
            bad.append("slo.ttft_ms: no observations — the measured pass "
                       "admitted nothing")
        elif ttft.get("p50") is None or ttft.get("p99") is None:
            bad.append("slo.ttft_ms: empty percentile row")
        if not isinstance(slo.get("tokens_per_s"), (int, float)) \
                or slo["tokens_per_s"] <= 0:
            bad.append("slo.tokens_per_s: missing or non-positive")
        shed = slo.get("shed") or {}
        for k in ("rate", "rejected_cache", "rejected_queue",
                  "rejected_deadline"):
            if k not in shed:
                bad.append(f"slo.shed.{k}: missing")
    return bad


def dump(report: Dict[str, Any]) -> str:
    lines = []
    for row in report.get("metrics", []):
        labels = ",".join(f"{k}={v}" for k, v in
                          sorted((row.get("labels") or {}).items()))
        name = row["name"] + (f"{{{labels}}}" if labels else "")
        if row["kind"] == "histogram":
            lines.append(f"{name}  count={row['count']} mean={row['mean']}"
                         f" p50={row['p50']} p90={row['p90']}"
                         f" p99={row['p99']} max={row['max']}")
        else:
            lines.append(f"{name}  {row['value']}")
    return "\n".join(lines)


def summary(report: Dict[str, Any]) -> str:
    if report.get("slo") is not None:
        from repro_torch.launch.loadgen import summarize
        return summarize(report)
    rows = report.get("metrics", [])
    kinds: Dict[str, int] = {}
    for row in rows:
        kinds[row.get("kind", "?")] = kinds.get(row.get("kind", "?"), 0) + 1
    return f"{len(rows)} series: " + \
        ", ".join(f"{v} {k}" for k, v in sorted(kinds.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="repro.obs/1 JSON report")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dump", action="store_true",
                      help="print every metric row")
    mode.add_argument("--check", action="store_true",
                      help="validate; exit 1 on schema violations or "
                           "empty percentile rows")
    args = ap.parse_args(argv)

    with open(args.path) as f:
        report = json.load(f)
    if args.check:
        bad = validate_report(report)
        if bad:
            for b in bad:
                print(f"FAIL {args.path}: {b}")
            return 1
        print(f"OK {args.path}: schema {report['schema']}, "
              f"{len(report['metrics'])} metric rows")
        return 0
    print(dump(report) if args.dump else summary(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
