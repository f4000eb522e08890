"""Open-loop Poisson load generator against the serving engine (counterpart
of ``repro/launch/loadgen.py``: the same presets, workload, report schema,
flags and exit codes, plus ``--device``).

Unlike ``launch/serve.py`` (closed loop: every request present at t=0),
this drives ``Engine.stream(..., arrivals=)`` with exponential
inter-arrival times — the open-loop model where the offered load does NOT
slow down when the server falls behind, so queueing delay shows up in
TTFT instead of being hidden by the harness.

The run is two passes over ONE engine:

1. **Warmup** (closed loop, throwaway registry): one batch per distinct
   (prompt-length, group-size) shape and one request per power-of-two
   decode chunk.  Nothing is compiled here, but on the card the kernels
   are built at their first use (``kernels/build.py``) and cuBLAS picks
   its algorithms, so without it the first measured TTFT would time the
   compiler.
2. **Measured** (open loop, fresh registry via ``Engine.bind_metrics``):
   the Poisson trace, timed end to end.

The workload mixes prompt/output lengths and includes deliberately
oversized requests (span > ``max_cache_tokens``) so the cache-pressure
shed path deterministically fires and the shed-rate row in the report is
never vacuously zero.

Output: a schema-versioned report (``repro.obs/1``) with the workload
spec, SLO summary (p50/p99 TTFT — both at the admission sync and on the
first *streamed* token, tokens/s, queue depth, cache occupancy, shed
rate), the full metric export, and event-log totals — written to
``results/BENCH_9_torch.json`` (the reference's ``results/BENCH_9.json``
is its own) and validated by ``launch/metrics.py --check``.

``--compare`` (the "paged" preset's natural mode) runs the SAME workload
through the block-paged pool and through a slot-contiguous baseline sized
to the same ``max_cache_tokens`` device budget, writes the paged report
(with the baseline SLO and a verdict embedded) to
``results/BENCH_10_torch.json``, and exits nonzero unless paging sustains
strictly more concurrent sessions at no p99-TTFT regression.

Params come from a ``torch.Generator`` seeded 0 on ``--device``: the card
by default (raising when torch sees none), ``--device cpu`` for the plain
PyTorch path.  On the card the paged pool takes 16-token blocks (the paged
decode kernel's), so the "paged" preset's 8-token blocks become 16 there;
the report's ``workload.block_size`` says which ran.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.loadgen --preset tiny \\
      [--out results/BENCH_9_torch.json] [--trace results/trace.json] \\
      [--n 24] [--rate 10] [--seed 0] [--device cuda|cpu]
  PYTHONPATH=src python -m repro_torch.launch.loadgen --preset paged \\
      --compare
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.events import EventLog
from repro_torch.obs.metrics import TTFT_MS_BUCKETS, Histogram
from repro_torch.obs.registry import SCHEMA, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve import Engine, GenerationConfig, Request
from repro_torch.serve.engine import CUDA_BLOCK_SIZE

DEFAULT_OUT = "results/BENCH_9_torch.json"
COMPARE_OUT = "results/BENCH_10_torch.json"

# Workload presets (the reference's).  Prompt lengths come from a tiny
# ladder; ``oversized`` counts requests rewritten to exceed the cache budget
# (deterministic sheds); ``shared_prefix`` tokens lead every prompt (a
# common system prompt, the shared-prefix-reuse case) and ``block_size``
# applies in paged mode.
PRESETS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(arch="qwen2-1.5b", n_requests=10, rate_rps=20.0,
                 prompt_lens=(4, 8), new_tokens=(4, 8), slots=2,
                 decode_block=8, max_cache_tokens=64,
                 max_queue_wait_ms=60_000.0, oversized=1),
    "full": dict(arch="qwen2-1.5b", n_requests=48, rate_rps=12.0,
                 prompt_lens=(8, 16), new_tokens=(8, 16), slots=4,
                 decode_block=16, max_cache_tokens=192,
                 max_queue_wait_ms=60_000.0, oversized=2),
    # the BENCH_10 comparison workload: mixed spans + a common system
    # prompt under ONE 64-token K/V budget.  The contiguous baseline fits
    # 64 // 32 = 2 full rows; paging fits whatever the footprints allow.
    "paged": dict(arch="qwen2-1.5b", n_requests=16, rate_rps=300.0,
                  prompt_lens=(8, 16), new_tokens=(4, 8), slots=6,
                  decode_block=4, max_cache_tokens=64,
                  max_queue_wait_ms=60_000.0, oversized=1,
                  block_size=8, shared_prefix=8),
}


def build_workload(cfg, p: Dict[str, Any], seed: int,
                   n: Optional[int] = None, rate: Optional[float] = None):
    """(requests, arrivals, n, rate) — a reproducible Poisson trace over
    mixed prompt/output lengths, with the last ``oversized`` requests
    rewritten to blow the cache budget."""
    n = int(n or p["n_requests"])
    rate = float(rate or p["rate_rps"])
    sp = int(p.get("shared_prefix", 0))
    rng = np.random.default_rng(seed)
    lens = rng.choice(p["prompt_lens"], size=n).astype(int)
    news = rng.choice(p["new_tokens"], size=n).astype(int)
    for j in range(min(p["oversized"], n)):
        lens[n - 1 - j] = p["max_cache_tokens"] + 8
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    prefix = (rng.integers(0, cfg.vocab_size, size=sp).astype(np.int32)
              if sp else None)
    reqs = []
    for i, (ln, nn) in enumerate(zip(lens, news)):
        toks = rng.integers(0, cfg.vocab_size, size=int(ln)).astype(np.int32)
        if prefix is not None:                 # common system prompt
            toks[:sp] = prefix[:int(ln)]
        reqs.append(Request(tokens=toks,
                            gen=GenerationConfig(max_new_tokens=int(nn)),
                            id=f"load-{i}"))
    return reqs, [float(a) for a in arrivals], n, rate


def _warmup(engine, cfg, p: Dict[str, Any], slots: int) -> None:
    """Run every shape the measured pass will hit once: one closed-loop
    batch per (prompt length, admitted-group size) — block-grained
    admission can admit ANY group size up to ``slots`` as blocks free up —
    plus a single-request sweep over the power-of-two decode chunk lengths
    (``Engine._chunk_len``)."""
    rng = np.random.default_rng(1)
    nn = int(min(p["new_tokens"]))
    ln0 = int(min(p["prompt_lens"]))
    # identical prompts per length: under block-grained admission a batch
    # of distinct prompts can exhaust the fresh-block budget and get split
    # into smaller groups, skipping the very shapes this loop exists to run
    prompts = {int(ln): rng.integers(0, cfg.vocab_size, size=int(ln)
                                     ).astype(np.int32)
               for ln in p["prompt_lens"]}

    def req(ln, nn, tag, i):
        return Request(tokens=prompts[int(ln)],
                       gen=GenerationConfig(max_new_tokens=int(nn)),
                       id=f"warm-{tag}-{i}")

    for ln in p["prompt_lens"]:
        for size in range(1, slots + 1):
            engine.generate([req(ln, nn, f"{ln}-{size}", i)
                             for i in range(size)])
    chunk = 1
    while chunk <= p["decode_block"]:
        # the first token comes out of the admit step, so ``chunk + 1`` new
        # tokens leave exactly ``chunk`` for one fused decode chunk
        engine.generate([req(ln0, chunk + 1, f"chunk-{chunk}", 0)])
        chunk *= 2


def _serve_trace(cfg, params, p: Dict[str, Any], *, preset: str, seed: int,
                 n: Optional[int], rate: Optional[float],
                 trace_path: Optional[str], paged: bool, slots: int,
                 device: torch.device) -> Dict[str, Any]:
    """Warm up, then serve ``p``'s Poisson trace open loop on ``cfg`` and
    ``params`` (any model: ``run_loadgen`` passes the preset's smoke model)
    and return the report."""
    block = CUDA_BLOCK_SIZE if device.type == "cuda" \
        else int(p.get("block_size", 16))
    events = EventLog(capacity=8192)
    tracer = Tracer()
    engine = Engine(cfg, params, device=device, max_slots=slots,
                    decode_block=p["decode_block"],
                    max_cache_tokens=p["max_cache_tokens"],
                    max_queue_wait_ms=p["max_queue_wait_ms"],
                    tracer=tracer, event_log=events,
                    paged=paged, block_size=block)
    _warmup(engine, cfg, p, slots)
    events.clear()                     # report covers the measured pass only
    measured = MetricsRegistry()
    engine.bind_metrics(measured)

    reqs, arrivals, n, rate = build_workload(cfg, p, seed, n=n, rate=rate)
    stream_ttft = Histogram("serve_ttft_stream_ms", TTFT_MS_BUCKETS)
    outs_by_idx: Dict[int, Any] = {}
    first_seen = set()
    t0 = time.perf_counter()
    for ev in engine.stream(reqs, arrivals=arrivals):
        if ev.kind == "delta" and ev.req_idx not in first_seen:
            first_seen.add(ev.req_idx)
            stream_ttft.observe(
                (time.perf_counter() - t0 - arrivals[ev.req_idx]) * 1e3)
        elif ev.kind == "done":
            outs_by_idx[ev.req_idx] = ev.completion
    wall = time.perf_counter() - t0
    outs = [outs_by_idx[i] for i in range(len(reqs))]

    if trace_path:
        os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
        tracer.write_chrome_trace(trace_path)

    export = measured.export()
    stats = engine.stats
    n_tokens = measured.get("serve_tokens_total").total()
    by_kind: Dict[str, int] = {}
    for ev in events.records():
        by_kind[ev.kind] = by_kind.get(ev.kind, 0) + 1
    return {
        "schema": SCHEMA,
        "kind": "loadgen",
        "preset": preset,
        "workload": {
            "arch": p["arch"], "n_requests": n, "rate_rps": rate,
            "seed": seed, "prompt_lens": list(p["prompt_lens"]),
            "new_tokens": list(p["new_tokens"]), "slots": slots,
            "decode_block": p["decode_block"],
            "max_cache_tokens": p["max_cache_tokens"],
            "max_queue_wait_ms": p["max_queue_wait_ms"],
            "oversized": p["oversized"],
            "paged": paged,
            "block_size": block if paged else None,
            "shared_prefix": int(p.get("shared_prefix", 0)),
        },
        "slo": {
            "ttft_ms": measured.get("serve_ttft_ms").summary(),
            "ttft_stream_ms": stream_ttft.summary(),
            "tokens_per_s": n_tokens / wall if wall > 0 else 0.0,
            "n_tokens": n_tokens,
            "wall_s": wall,
            "queue_depth": measured.get("serve_queue_depth").summary(),
            "slots_busy": measured.get("serve_slots_busy").summary(),
            "peak_slots_busy":
                measured.get("serve_peak_slots_busy").value(),
            "cache_tokens": measured.get("serve_cache_tokens").value(),
            "shed": {
                "rate": sum(stats.values()) / n,
                **stats,
            },
            "completed": sum(1 for c in outs
                             if c.finish_reason in ("eos", "length")),
        },
        "metrics": export["metrics"],
        "events": {"n": len(events), "dropped": events.dropped,
                   "by_kind": by_kind},
    }


def preset_model(preset: str, device="cuda", params=None):
    """(cfg, params) of a preset: its arch's smoke config in fp32, params
    from a ``torch.Generator`` seeded 0 on ``device`` unless given."""
    cfg = get(PRESETS[preset]["arch"], smoke=True).replace(dtype="float32")
    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    return cfg, params


def run_loadgen(preset: str = "tiny", *, seed: int = 0,
                n: Optional[int] = None, rate: Optional[float] = None,
                trace_path: Optional[str] = None, paged: bool = False,
                slots: Optional[int] = None, device="cuda",
                params=None) -> Dict[str, Any]:
    """One full loadgen run; returns the schema-versioned report dict.

    ``paged=True`` serves through the block-paged pool (block size from the
    preset; 16 on the card); ``slots`` overrides the preset's scheduler
    slots — the compare mode uses it to size the contiguous baseline to the
    same token budget.  ``params`` (a tree of the preset's smoke model, e.g.
    the reference's through ``convert.params_from_numpy``) replaces the
    seed-0 draw.  The measured pass is driven through ``Engine.stream`` so
    TTFT is also measured on the first *streamed* token
    (``slo.ttft_stream_ms``), not just at the admission sync
    (``slo.ttft_ms``)."""
    p = PRESETS[preset]
    device = resolve_device(device)
    cfg, params = preset_model(preset, device, params)
    return _serve_trace(cfg, params, p, preset=preset, seed=seed, n=n,
                        rate=rate, trace_path=trace_path, paged=paged,
                        slots=int(slots or p["slots"]), device=device)


def run_compare(preset: str = "paged", *, seed: int = 0,
                n: Optional[int] = None, rate: Optional[float] = None,
                trace_path: Optional[str] = None,
                bench9_path: str = DEFAULT_OUT, device="cuda",
                params=None) -> Dict[str, Any]:
    """Paged vs slot-contiguous on the SAME workload and device budget.

    The contiguous baseline gets ``max_cache_tokens // row`` slots, where
    ``row`` is the per-slot cache length the engine would allocate for the
    longest in-budget span — i.e. both pools hold the same number of K/V
    tokens, the only difference is the allocation granularity.  The paged
    run must sustain *strictly more* concurrent sessions and keep p99
    TTFT within ``max(1.25x, +25ms)`` of the baseline (and at or below the
    p99 of the report at ``bench9_path`` when that file is present);
    ``comparison.ok`` records the verdict and ``main --compare`` turns it
    into the exit code.  The returned dict is the paged report (still a
    valid ``repro.obs/1`` loadgen report for ``launch.metrics --check``)
    with ``baseline`` and ``comparison`` sections embedded."""
    p = PRESETS[preset]
    device = resolve_device(device)
    _, params = preset_model(preset, device, params)
    span = max(p["prompt_lens"]) + max(p["new_tokens"])
    row = -(-span // 32) * 32          # engine rounds cache rows up to 32
    ctg_slots = max(1, p["max_cache_tokens"] // row)
    paged_rep = run_loadgen(preset, seed=seed, n=n, rate=rate,
                            trace_path=trace_path, paged=True,
                            device=device, params=params)
    ctg_rep = run_loadgen(preset, seed=seed, n=n, rate=rate,
                          paged=False, slots=ctg_slots, device=device,
                          params=params)

    p_slo, c_slo = paged_rep["slo"], ctg_rep["slo"]
    p_peak, c_peak = p_slo["peak_slots_busy"], c_slo["peak_slots_busy"]
    p_p99 = p_slo["ttft_ms"]["p99"]
    c_p99 = c_slo["ttft_ms"]["p99"]
    comparison: Dict[str, Any] = {
        "baseline_slots": ctg_slots,
        "paged_peak_slots_busy": p_peak,
        "contiguous_peak_slots_busy": c_peak,
        "concurrency_ok": bool(p_peak > c_peak),
        "paged_p99_ttft_ms": p_p99,
        "contiguous_p99_ttft_ms": c_p99,
        "ttft_ok": bool(p_p99 <= max(c_p99 * 1.25, c_p99 + 25.0)),
        "paged_completed": p_slo["completed"],
        "contiguous_completed": c_slo["completed"],
    }
    if bench9_path and os.path.exists(bench9_path):
        with open(bench9_path) as f:
            b9 = json.load(f)["slo"]["ttft_ms"]["p99"]
        comparison["bench9_p99_ttft_ms"] = b9
        comparison["ttft_ok_vs_bench9"] = bool(p_p99 <= b9)
    comparison["ok"] = all(v for k, v in comparison.items()
                           if k.endswith("_ok") or "_ok_" in k)
    paged_rep["baseline"] = {"workload": ctg_rep["workload"],
                             "slo": c_slo}
    paged_rep["comparison"] = comparison
    return paged_rep


def summarize(report: Dict[str, Any]) -> str:
    s = report["slo"]
    ttft = s["ttft_ms"]
    shed = s["shed"]
    mode = "paged" if report["workload"].get("paged") else "contiguous"
    line = (f"loadgen[{report['preset']}/{mode}]"
            f" n={report['workload']['n_requests']}"
            f" rate={report['workload']['rate_rps']:.1f}rps | "
            f"ttft p50={ttft['p50']:.1f}ms p99={ttft['p99']:.1f}ms | "
            f"{s['tokens_per_s']:.1f} tok/s | "
            f"queue p99={s['queue_depth']['p99']} | "
            f"shed {shed['rate']:.2f} "
            f"(cache={shed['rejected_cache']} queue={shed['rejected_queue']}"
            f" deadline={shed['rejected_deadline']}) | "
            f"completed {s['completed']}")
    st = s.get("ttft_stream_ms")
    if st and st.get("count"):
        line += f" | stream-ttft p99={st['p99']:.1f}ms"
    cmp_ = report.get("comparison")
    if cmp_:
        line += (f"\ncompare: paged peak={cmp_['paged_peak_slots_busy']}"
                 f" vs contiguous peak={cmp_['contiguous_peak_slots_busy']}"
                 f" ({cmp_['baseline_slots']} slots) | "
                 f"p99 ttft {cmp_['paged_p99_ttft_ms']:.1f}ms vs "
                 f"{cmp_['contiguous_p99_ttft_ms']:.1f}ms | "
                 f"{'OK' if cmp_['ok'] else 'FAIL'}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--out", default=None,
                    help=f"report path (default {DEFAULT_OUT}, or "
                         f"{COMPARE_OUT} with --compare)")
    ap.add_argument("--trace", default=None,
                    help="also write the Chrome trace JSON here")
    ap.add_argument("--n", type=int, default=None,
                    help="override the preset's request count")
    ap.add_argument("--rate", type=float, default=None,
                    help="override the preset's offered rate (req/s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="serve through the block-paged cache pool")
    ap.add_argument("--compare", action="store_true",
                    help="run paged AND a budget-matched contiguous "
                         "baseline on the same workload; exit nonzero "
                         "unless paging wins (BENCH_10 mode)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.compare:
        report = run_compare(args.preset, seed=args.seed, n=args.n,
                             rate=args.rate, trace_path=args.trace,
                             device=args.device)
    else:
        report = run_loadgen(args.preset, seed=args.seed, n=args.n,
                             rate=args.rate, trace_path=args.trace,
                             paged=args.paged, device=args.device)
    out = args.out or (COMPARE_OUT if args.compare else DEFAULT_OUT)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(summarize(report))
    print(f"wrote {out}" + (f" and {args.trace}" if args.trace else ""))
    return 0 if report.get("comparison", {}).get("ok", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
