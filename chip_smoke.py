"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--phases device,build,kernels,...] [--out results.json]

Phases, each of which fails the run (exit code 1) if anything in it fails:

1. device    -- the card's name and power limit (nvidia-smi).
2. build     -- compiles every ``kernels/csrc/*.cu`` with nvcc for sm_90a
                and prints the ptxas register / shared-memory / spill lines.
3. kernels   -- each hand-written kernel against its plain PyTorch version
                on the same card tensors, at qwen2-1.5b's attention shapes,
                in bf16 and fp32: the largest absolute error, and the
                largest error of an output row relative to that row's RMS.
4. reference -- the smoke qwen2 model at fp32 on the card (kernels) against
                the same model on the CPU (plain versions): prefill and
                decode logits, and greedy engine tokens.
5. serve     -- qwen2-1.5b at full width from seeded random weights through
                ``Engine(precision="bf16", max_slots=8)``: 8 greedy and 2
                sampled requests, once on the contiguous pool and once
                paged.  Greedy tokens must agree between the pools, and
                every kernel's launch count must be > 0 (counts are zeroed
                just before each run and read just after).  A short run is
                profiled: device time by kernel family, and the host time,
                device time and kernel launches of each decode step.
6. timing    -- each kernel, its plain version and one PyTorch library call
                timed with CUDA events at the main path's shapes, beside the
                least time the card could take for the same work.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the per-kernel JSON.  Without a CUDA device, or
without the repository's ``src/`` beside it, the script exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# max|err| of an output row (one query, one head) over the RMS of that row:
# bf16 rounds the output to 8 bits (a 1-ulp disagreement is 0.4-0.8% of an
# element, ~2.5% of the row RMS at worst), while one dropped key at Lc ~1000
# moves a row by ~10% of its RMS
REL_TOL = {"bfloat16": 5e-2, "float32": 1e-3}
PHASES = ("device", "build", "kernels", "reference", "serve", "timing")

# qwen2-1.5b attention at full width
B_PREFILL, H, KV, D = 2, 12, 2, 128
B_DECODE, LC, BLOCK = 8, 1056, 16
DECODE_POS = (0, 15, 16, 100, 511, 1000, 1055, 1500)   # ragged, two >= Lc

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
TPU_KERNEL = "src/repro/kernels/flash_attention/kernel.py"
KERNELS = {
    "flash_attention": f"{TPU_KERNEL}:196",
    "decode_attention": f"{TPU_KERNEL}:275",
    "paged_decode_attention": f"{TPU_KERNEL}:329",
}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


# -- phase 1 -------------------------------------------------------------------

def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def phase_device(torch, report):
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    report["device"] = {"name": name, "count": torch.cuda.device_count(),
                        "nvidia_smi": smi,
                        "capability": list(torch.cuda.get_device_capability(0)),
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    log(f"device: {name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    require(tuple(torch.cuda.get_device_capability(0)) == (9, 0),
            "the kernels are built for sm_90a (Hopper)")


# -- phase 2 -------------------------------------------------------------------

def phase_build(report):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    report["build_s"] = dt
    log(f"built {sorted(logs) or 'nothing (current)'} in {dt:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"  ptxas[{name}]: {line.strip()}")


# -- phase 3 -------------------------------------------------------------------

def _rand(torch, gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def prefill_inputs(torch, gen, dev, dtype, sq, sk, b=B_PREFILL):
    return (_rand(torch, gen, (b, sq, H, D), dtype, dev),
            _rand(torch, gen, (b, sk, KV, D), dtype, dev),
            _rand(torch, gen, (b, sk, KV, D), dtype, dev))


def decode_inputs(torch, gen, dev, dtype):
    """q, a shuffled paged pool with garbage pads, its block table, pos, and
    the contiguous (B, Lc, KV, D) view gathered through the table."""
    nb = LC // BLOCK + 1                    # one pad column past Lc
    n_blocks = B_DECODE * nb + 1            # + the garbage block 0
    q = _rand(torch, gen, (B_DECODE, 1, H, D), dtype, dev)
    kp = _rand(torch, gen, (n_blocks, BLOCK, KV, D), dtype, dev)
    vp = _rand(torch, gen, (n_blocks, BLOCK, KV, D), dtype, dev)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm[:B_DECODE * nb].reshape(B_DECODE, nb).to(torch.int32)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    for b, p in enumerate(DECODE_POS):      # blocks past a request's span
        first_unused = min(p, LC - 1) // BLOCK + 1
        bt[b, first_unused:] = 0            # point at the garbage block
    bt[:, -1] = 0
    kc = kp[bt.long()].reshape(B_DECODE, nb * BLOCK, KV, D)[:, :LC]
    vc = vp[bt.long()].reshape(B_DECODE, nb * BLOCK, KV, D)[:, :LC]
    return q, kp, vp, bt, pos, kc.contiguous(), vc.contiguous()


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def row_rel_err(got, want) -> float:
    """max over output rows (last dim) of max|got - want| / rms(want row)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt().clamp_min(1e-12)
    return ((g - w).abs().amax(-1) / rms).max().item()


def phase_kernels(torch, dev, report):
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    rel_errs = {k: {} for k in KERNELS}
    checks = []

    def check(name, what, dtype, got, want):
        err, rel = max_err(got, want), row_rel_err(got, want)
        tol, rtol = TOL[dtype], REL_TOL[dtype]
        errs[name] = max(errs[name], err)
        rel_errs[name][dtype] = max(rel_errs[name].get(dtype, 0.0), rel)
        checks.append({"kernel": name, "case": what, "dtype": dtype,
                       "max_abs_err": err, "tol": tol,
                       "max_row_rel_err": rel, "rel_tol": rtol})
        log(f"  {name:24s} {what:34s} {dtype:9s} max|err| {err:.3e} "
            f"(tol {tol:g}), row-relative {rel:.3e} (tol {rtol:g})")
        require(math.isfinite(err) and err <= tol,
                f"{name} {what} {dtype}: max|err| {err} > {tol}")
        require(math.isfinite(rel) and rel <= rtol,
                f"{name} {what} {dtype}: row-relative err {rel} > {rtol}")

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        for sq, sk, window in ((1000, 1000, 0), (1024, 1024, 0),
                               (1024, 1024, 256), (384, 1024, 0)):
            q, k, v = prefill_inputs(torch, gen, dev, dtype, sq, sk)
            got = K.flash_attention_cuda(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            want = R.chunked_attention(q, k, v, causal=True, window=window)
            check("flash_attention", f"B2 Sq{sq} Sk{sk} win{window}", dn,
                  got, want)
        q, kp, vp, bt, pos, kc, vc = decode_inputs(torch, gen, dev, dtype)
        got_c = K.decode_attention_cuda(q, kc, vc, pos)
        got_p = K.paged_decode_attention_cuda(q, kp, vp, bt, pos,
                                              logical_len=LC)
        torch.cuda.synchronize()
        check("decode_attention", f"B8 Lc{LC} ragged pos", dn,
              got_c, R.decode_attention(q, kc, vc, pos))
        check("paged_decode_attention", f"B8 Lc{LC} BS16 shuffled+pads", dn,
              got_p, R.paged_decode_attention(q, kp, vp, bt, pos,
                                              logical_len=LC))
        require(torch.equal(got_c, got_p),
                f"paged != contiguous decode bitwise ({dn})")
        log(f"  paged == contiguous decode bitwise ({dn})")
    report["kernel_checks"] = checks
    report["max_abs_err"] = errs
    report["max_row_rel_err"] = rel_errs


# -- phase 4 -------------------------------------------------------------------

def smoke_requests(cfg, GenerationConfig, Request):
    import numpy as np
    rng = np.random.RandomState(0)
    return [Request(tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
                    gen=GenerationConfig(max_new_tokens=nn), id=f"s{i}")
            for i, (ln, nn) in enumerate(((40, 12), (17, 20), (40, 9),
                                          (70, 16)))]


def phase_reference(torch, dev, report):
    """The port on the card against its plain path on the CPU, fp32."""
    from repro_torch.configs import get
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, GenerationConfig, Request
    from repro_torch.tree import tree_map
    cfg = get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    dparams = tree_map(lambda t: t.to(dev), params)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    worst = 0.0
    lc, cache = {}, {}
    for name, p, d in (("cpu", params, "cpu"), ("cuda", dparams, dev)):
        lc[name], cache[name], _ = M.prefill(cfg, p, {"tokens": toks.to(d)},
                                             64)
    worst = max(worst, max_err(lc["cuda"].cpu(), lc["cpu"]))
    tok = torch.argmax(lc["cpu"][:, :cfg.vocab_size], -1)
    pos = torch.tensor([40, 40], dtype=torch.int32)
    for _ in range(3):
        out = {}
        for name, p, d in (("cpu", params, "cpu"), ("cuda", dparams, dev)):
            out[name], _ = M.decode_step(cfg, p, cache[name], tok.to(d),
                                         pos.to(d))
        worst = max(worst, max_err(out["cuda"].cpu(), out["cpu"]))
        tok = torch.argmax(out["cpu"][:, :cfg.vocab_size], -1)
        pos = pos + 1
    log(f"  smoke fp32 prefill + 3 decode logits, card vs CPU: max|err| "
        f"{worst:.3e} (tol 1e-4)")
    require(worst <= 1e-4, f"card vs CPU logits differ by {worst}")
    reqs = smoke_requests(cfg, GenerationConfig, Request)
    toks_by = {}
    for d, paged in (("cpu", False), (dev, False), (dev, True)):
        eng = Engine(cfg, params, device=d, max_slots=2, decode_block=4,
                     paged=paged)
        toks_by[(str(d), paged)] = [c.tokens for c in eng.generate(reqs)]
    want = toks_by[("cpu", False)]
    for key, got in toks_by.items():
        require(got == want, f"engine tokens on {key} differ from the CPU's")
    log(f"  smoke fp32 engine greedy tokens: card contiguous == card paged "
        f"== CPU ({sum(len(t) for t in want)} tokens)")
    report["reference"] = {"logits_max_abs_err": worst, "tol": 1e-4,
                           "engine_tokens_equal": True}


# -- phase 5 -------------------------------------------------------------------

def serve_requests(cfg, GenerationConfig, Request):
    import numpy as np
    rng = np.random.RandomState(0)
    greedy = [(64, 32), (96, 40), (128, 48), (200, 64), (256, 36),
              (333, 56), (420, 44), (512, 64)]
    reqs = [Request(tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
                    gen=GenerationConfig(max_new_tokens=nn), id=f"g{i}")
            for i, (ln, nn) in enumerate(greedy)]
    for i, (ln, nn) in enumerate(((150, 48), (300, 40))):
        reqs.append(Request(
            tokens=rng.randint(0, cfg.vocab_size, size=(ln,)),
            gen=GenerationConfig(max_new_tokens=nn, temperature=0.8,
                                 top_k=50, top_p=0.95, seed=100 + i),
            id=f"s{i}"))
    return reqs


def run_engine(torch, engine, reqs, LAUNCHES):
    """One measured generate(): tokens, TTFTs, wall time, launch counts."""
    engine.tracer.spans.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    first = {}
    done = {}
    for ev in engine.stream(reqs):
        if ev.kind == "delta" and ev.req_idx not in first:
            first[ev.req_idx] = time.perf_counter() - t0
        elif ev.kind == "done":
            done[ev.req_idx] = ev.completion
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    steps = [(s.dur, s.args.get("steps", 0)) for s in engine.tracer.spans
             if s.name.startswith("decode[")]
    n_steps = sum(n for _, n in steps)
    comps = [done[i] for i in range(len(reqs))]
    ttft = sorted(first.values())
    return {
        "tokens": [list(c.tokens) for c in comps],
        "n_generated": sum(len(c.tokens) for c in comps),
        "wall_s": wall,
        "tokens_per_s": sum(len(c.tokens) for c in comps) / wall,
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "ttft_max_ms": 1e3 * ttft[-1],
        "decode_steps": n_steps,
        "ms_per_decode_step": 1e3 * sum(d for d, _ in steps) / max(n_steps,
                                                                    1),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
    }


def kernel_family(name: str) -> str:
    if "prefill_kernel" in name:
        return "flash_attention (ours)"
    if "decode_kernel" in name:
        return "decode attention (ours)"
    if any(w in name for w in ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                               "splitK")):
        return "matmul (cuBLAS)"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort (sampling)"
    if "index" in name.lower() or "scatter" in name.lower():
        return "index/scatter"
    if "reduce" in name.lower():
        return "reductions"
    return "elementwise/other"


SYNC_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaEventSynchronize")


def is_range(name: str) -> bool:
    """An engine span made a profiler range; with CPU activity on, the
    profiler also puts it on the device timeline as an annotation spanning
    its kernels, which is no device work of its own."""
    return name.startswith("decode[") or name == "admit"


def decode_split(events):
    """Host time, host time spent waiting in CUDA sync calls, device time and
    kernel launches (ms, ms, ms, n) under the ``decode[n]`` profiler ranges."""
    from torch.autograd import DeviceType
    host = wait = dev = 0.0
    launches = 0
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.name.startswith(
                "decode["):
            continue
        host += ev.cpu_time_total / 1e3
        stack = [ev]
        while stack:
            e = stack.pop()
            kernels = [k for k in e.kernels if not is_range(k.name)]
            launches += len(kernels)
            dev += sum(k.duration for k in kernels) / 1e3
            if e.name in SYNC_CALLS:
                wait += e.cpu_time_total / 1e3
            stack.extend(e.cpu_children)
    return host, wait, dev, launches


def decode_spans(engine):
    """(host ms, steps) over the engine's ``decode[n]`` spans."""
    spans = [s for s in engine.tracer.spans if s.name.startswith("decode[")]
    return (1e3 * sum(s.dur for s in spans),
            sum(s.args.get("steps", 0) for s in spans))


def profile_run(torch, engine, reqs):
    """One generate() of ``reqs`` unprofiled, then one under torch.profiler
    with CPU and CUDA activity, where each engine span is also a profiler
    range.  Gives device time by kernel family, the busy share (device time
    / the unprofiled wall time), and per decode step: host time unprofiled
    and profiled, the profiled host time waiting in sync calls, device
    time and kernel launches."""
    from contextlib import contextmanager
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    engine.tracer.spans.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plain_host, steps = decode_spans(engine)
    engine.tracer.spans.clear()
    span = engine.tracer.span

    @contextmanager
    def ranged_span(name, **kw):
        with record_function(name), span(name, **kw):
            yield

    engine.tracer.span = ranged_span
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.generate(reqs)
            torch.cuda.synchronize()
    finally:
        del engine.tracer.span             # back to the class's method
    prof_host, prof_steps = decode_spans(engine)
    fam = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or is_range(e.key):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        f = kernel_family(e.key)
        ms, n = fam.get(f, (0.0, 0))
        fam[f] = (ms + us / 1e3, n + e.count)
    total = sum(ms for ms, _ in fam.values())
    host, wait, dev, launches = decode_split(prof.events())
    per = max(prof_steps, 1)
    return {"requests": len(reqs), "wall_ms": 1e3 * wall,
            "device_ms": total, "busy_share": total / (1e3 * wall),
            "families": {f: {"ms": ms, "launches": n}
                         for f, (ms, n) in sorted(fam.items(),
                                                  key=lambda x: -x[1][0])},
            "decode_steps": prof_steps,
            "decode_per_step": {
                "host_ms_unprofiled": plain_host / max(steps, 1),
                "host_ms_span_profiled": prof_host / per,
                "host_ms_range_profiled": host / per,
                "sync_wait_ms_profiled": wait / per,
                "device_ms": dev / per,
                "launches": launches / per,
                "host_us_per_launch_profiled":
                    1e3 * (host - wait) / max(launches, 1)}}


def phase_serve(torch, dev, report):
    from repro_torch.configs import get
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.precision import tree_bytes
    from repro_torch.serve import Engine, GenerationConfig, Request
    cfg = get("qwen2-1.5b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_padded}; random "
        f"fp32 weights in {time.perf_counter() - t0:.1f}s")
    reqs = serve_requests(cfg, GenerationConfig, Request)
    runs = {}
    for paged in (False, True):
        label = "paged" if paged else "contiguous"
        engine = Engine(cfg, params, device=dev, precision="bf16",
                        max_slots=8, paged=paged)
        engine.generate(reqs)        # warm-up: cuBLAS picks per new shape
        runs[label] = r = run_engine(torch, engine, reqs, LAUNCHES)
        r["pool_bytes"] = engine._pool.nbytes
        log(f"  {label:10s}: {r['n_generated']} tokens in {r['wall_s']:.2f}s"
            f" = {r['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.1f} ms (max {r['ttft_max_ms']:.1f}), "
            f"{r['ms_per_decode_step']:.2f} ms/decode step over "
            f"{r['decode_steps']} steps, peak {r['peak_mem_gib']:.2f} GiB, "
            f"pool {r['pool_bytes'] / 2**20:.0f} MiB, launches "
            f"{r['launches']}")
        if not paged:     # the pools' device work differs only in attention
            short = [dataclasses.replace(q, gen=q.gen.replace(
                max_new_tokens=16)) for q in reqs[:4]]
            r["profile"] = prof = profile_run(torch, engine, short)
            log(f"    profiled 4 requests x 16 tokens: device busy "
                f"{prof['device_ms']:.1f} ms of {prof['wall_ms']:.0f} ms "
                f"({100 * prof['busy_share']:.1f}%)")
            for f, v in prof["families"].items():
                log(f"      {f:26s} {v['ms']:9.2f} ms  {v['launches']:7d} "
                    "launches")
            d = prof["decode_per_step"]
            log(f"    per decode step ({prof['decode_steps']} steps): host "
                f"{d['host_ms_unprofiled']:.2f} ms unprofiled, "
                f"{d['host_ms_range_profiled']:.2f} ms profiled of which "
                f"{d['sync_wait_ms_profiled']:.2f} ms waiting in sync calls;"
                f" device {d['device_ms']:.2f} ms; {d['launches']:.0f} "
                f"launches, {d['host_us_per_launch_profiled']:.1f} us of "
                "host time each (profiled)")
            require(d["device_ms"] > 0 and d["launches"] > 0,
                    "the profile attributed no device work to decode steps")
        del engine
        torch.cuda.empty_cache()
        for req, toks in zip(reqs, r["tokens"]):
            require(len(toks) == req.gen.max_new_tokens,
                    f"{req.id}: {len(toks)} tokens, expected "
                    f"{req.gen.max_new_tokens}")
            require(all(0 <= t < cfg.vocab_size for t in toks),
                    f"{req.id}: token outside the vocabulary")
    c, p = runs["contiguous"], runs["paged"]
    greedy = [i for i, r in enumerate(reqs) if r.gen.temperature <= 0]
    same = [c["tokens"][i] == p["tokens"][i] for i in range(len(reqs))]
    require(all(same[i] for i in greedy),
            "greedy tokens differ between the contiguous and paged pools")
    log(f"  greedy tokens identical across pools ({len(greedy)} requests); "
        f"sampled identical: {all(same)}")
    require(c["launches"].get("flash_attention", 0) > 0
            and c["launches"].get("decode_attention", 0) > 0,
            f"contiguous run missed a kernel: {c['launches']}")
    require(p["launches"].get("flash_attention", 0) > 0
            and p["launches"].get("paged_decode_attention", 0) > 0,
            f"paged run missed a kernel: {p['launches']}")
    weights = tree_bytes(params) // 2      # fp32 storage -> bf16 copy
    report["serve"] = {"layers": cfg.n_layers, "runs": runs,
                       "sampled_equal": all(same),
                       "bf16_weight_bytes": weights,
                       "weights_bound_ms_per_step":
                       1e3 * weights / HBM_BYTES_PER_S}
    log(f"  weights-bound decode step: {weights / 1e9:.2f} GB of bf16 "
        f"weights -> {1e3 * weights / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s")
    launches = {k: c["launches"].get(k, 0) + p["launches"].get(k, 0)
                for k in KERNELS}
    report["launches"] = launches
    del params
    torch.cuda.empty_cache()


# -- phase 6 -------------------------------------------------------------------

def time_ms(torch, fn, arg_sets, iters=50):
    """Mean ms per call with CUDA events, cycling over ``arg_sets`` (sized
    past the 50 MB L2, so every call reads its inputs from HBM)."""
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(bytes_per_set: int) -> int:
    return max(2, -(-200 * 2**20 // bytes_per_set))


def phase_timing(torch, dev, report):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    gen = torch.Generator(device=dev).manual_seed(2)
    dtype, dn = torch.bfloat16, "bfloat16"
    item = 2
    out = {}

    # prefill: B=2, S=1024 causal
    s = 1024
    per = item * (2 * B_PREFILL * s * H * D + 2 * B_PREFILL * s * KV * D)
    sets = [prefill_inputs(torch, gen, dev, dtype, s, s)
            for _ in range(n_sets(per))]
    pairs = s * (s + 1) // 2                     # causal (q, k) pairs
    flops = 4 * D * H * B_PREFILL * pairs
    out["flash_attention"] = {
        "shape": f"B{B_PREFILL} S{s} H{H} KV{KV} D{D} causal {dn}",
        "ms": time_ms(torch, lambda q, k, v: K.flash_attention_cuda(q, k, v),
                      sets),
        "plain_ms": time_ms(torch, lambda q, k, v: R.chunked_attention(
            q, k, v), sets, iters=10),
        "library_ms": time_ms(torch, lambda q, k, v:
                              F.scaled_dot_product_attention(
                                  q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), is_causal=True,
                                  enable_gqa=True), sets),
        "bytes": per, "flops": flops}

    # decode and paged decode: B=8, Lc=1056, ragged pos
    q, kp, vp, bt, pos, kc, vc = decode_inputs(torch, gen, dev, dtype)
    valid = [min(p + 1, LC) for p in DECODE_POS]
    kv_bytes = item * 2 * KV * D * sum(valid)
    qo_bytes = item * 2 * B_DECODE * H * D + 4 * B_DECODE
    dec_flops = 4 * D * H * sum(valid)
    per = item * (kc.numel() + vc.numel())
    k_sets = [(q, kc.clone(), vc.clone(), pos) for _ in range(n_sets(per))]
    p_sets = [(q, kp.clone(), vp.clone(), bt, pos)
              for _ in range(n_sets(item * (kp.numel() + vp.numel())))]
    slot = torch.arange(LC, device=dev)
    mask = (slot[None, :] <= pos[:, None].long())[:, None, None, :]
    out["decode_attention"] = {
        "shape": f"B{B_DECODE} Lc{LC} H{H} KV{KV} D{D} ragged pos {dn}",
        "ms": time_ms(torch, K.decode_attention_cuda, k_sets),
        "plain_ms": time_ms(torch, R.decode_attention, k_sets),
        "library_ms": time_ms(torch, lambda q_, k_, v_, p_:
                              F.scaled_dot_product_attention(
                                  q_.transpose(1, 2), k_.transpose(1, 2),
                                  v_.transpose(1, 2), attn_mask=mask,
                                  enable_gqa=True), k_sets),
        "bytes": kv_bytes + qo_bytes, "flops": dec_flops}
    tbl = 4 * sum(-(-v // BLOCK) for v in valid)
    out["paged_decode_attention"] = {
        "shape": f"B{B_DECODE} Lc{LC} BS{BLOCK} H{H} KV{KV} D{D} {dn}",
        "ms": time_ms(torch, lambda q_, k_, v_, b_, p_:
                      K.paged_decode_attention_cuda(q_, k_, v_, b_, p_,
                                                    logical_len=LC), p_sets),
        "plain_ms": time_ms(torch, lambda q_, k_, v_, b_, p_:
                            R.paged_decode_attention(q_, k_, v_, b_, p_,
                                                     logical_len=LC),
                            p_sets),
        "library_ms": None,      # no single PyTorch call gathers pages
        "bytes": kv_bytes + qo_bytes + tbl, "flops": dec_flops}
    for name, t in out.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S
        t_ops = t["flops"] / PEAK_FLOPS[dn]
        t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = t["library_ms"]
        log(f"  {name:24s} {t['shape']:40s} kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    report["timing"] = out


# -- main ------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; the port's kernels run "
              "only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no {SRC / 'repro_torch'}; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    report = {}
    t_start = time.perf_counter()
    failed = []
    for phase in PHASES:
        if phase not in phases:
            continue
        log(f"== {phase}")
        t0 = time.perf_counter()
        try:
            if phase == "device":
                phase_device(torch, report)
            elif phase == "build":
                phase_build(report)
            elif phase == "kernels":
                phase_kernels(torch, dev, report)
            elif phase == "reference":
                phase_reference(torch, dev, report)
            elif phase == "serve":
                phase_serve(torch, dev, report)
            elif phase == "timing":
                phase_timing(torch, dev, report)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- report every phase's fault
            import traceback
            traceback.print_exc()
            failed.append(phase)
            log(f"FAILED phase {phase}: {type(e).__name__}: {e}")
        log(f"   ({phase}: {time.perf_counter() - t0:.1f}s)")
    report["failed"] = failed
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1
    if set(phases) != set(PHASES):
        log(f"chip_smoke: partial run ({','.join(phases)}), no result")
        return 0

    kernels = []
    timing = report.get("timing", {})
    for name, replaces in KERNELS.items():
        t = timing.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces,
            "launches": report.get("launches", {}).get(name),
            "max_abs_err": report.get("max_abs_err", {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    log(smi_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
