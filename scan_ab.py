"""Times two versions of the selective-scan, its backward, SIL-MSE,
serve-prefill attention and attention-backward kernels on one card, in
turns, and counts the SASS of the scan's, its backward's and SIL-MSE's
inner loops.

    python3 scan_ab.py --other DIR [--out FILE]
    python3 scan_ab.py --other DIR --probe [--out FILE]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  The script runs one worker process per turn, in the order other,
this, this, other; each worker builds its checkout's
``kernels/csrc/selective_scan.cu``, ``sil_mse.cu`` and ``flash_attention.cu``
with that checkout's ``build.py``, and times its ``selective_scan_cuda`` at
``chip_smoke.SCAN_TIMED`` (bf16 u, zero h0), after a second of
back-to-back calls that brings the card to its clocks under load: the
kernel's own device time from the profiler, and CUDA events over
back-to-back calls.  Then its ``selective_scan_bwd_cuda`` at
``chip_smoke.SCAN_TRAIN`` (bf16 u, on the states its own saving forward
wrote), with B and C contiguous and as column views of one (Ba, S, R + 2N)
tensor as the train cut hands them over: the device time of every kernel
whose name holds ``scan_bwd``, summed and each on its own, and CUDA events.
Then its ``sil_mse_cuda`` through
``chip_smoke.time_sil_mse`` at the paper boundary and the LM SIL: the
device time of every SIL-MSE kernel a call (summed) and the kernels a call,
the events time, the empty-kernel floor where the checkout has one, and the
wrapper's host time step by step (``chip_smoke.sil_host_split``).  Then
its ``flash_attention_cuda`` as the serve path calls it (no log-sum-exp)
at ``PREFILL_TIMED`` (bf16, causal, qwen2-1.5b's 12/2 heads of 128), after
a second of back-to-back calls: device time and CUDA events.  Then its
``flash_attention_bwd_cuda`` at ``BWD_TIMED`` (causal: qwen2-1.5b's train
layer, B8 S1024, in bf16, and its heads at B2 in fp32; lse from the
checkout's own training forward), after a second of back-to-back calls:
the device time of its kernels (every kernel whose name holds
``attn_bwd``, summed) and CUDA events.  Each worker also disassembles its libraries (``cuobjdump -sass``): for every
instantiation of ``scan_kernel`` and ``scan_bwd_kernel`` it finds the loop
(a backward branch) that holds the most ``MUFU.EX2`` and counts its
instructions (NOPs left out), its exponentials and its shuffles (``SHFL``):
the loop body runs straight through for a whole tile, so the forward's
ratio is the instructions issued per (t, d, n), and the backward's counts
over the (t, d, n) a thread walks a tile (``elements_per_trip``, from the
checkout's tiling) are its exponentials and instructions per element; for
every SIL-MSE kernel, the loop with the most global loads, its
instructions and its 16-byte loads (``LDG.E.128``), and the kernel's
16-byte loads and stores in all.  Each worker also keeps ptxas's
registers, spill bytes and static shared memory for every kernel it built.

``--probe`` measures what holds the other checkout's backward back instead:
it copies that checkout's ``src/`` under ``build/probe/<name>/`` once per
entry of ``PROBES``, edits the copy's ``selective_scan.cu`` there (the
walk without its per-step dB/dC shuffles and stores; without its staging
of u, dt, dy, B and C after the first tile; without both; and as it is),
and runs one worker per copy that builds it and times its backward alone.
The edits match the first version of the backward (one channel a thread,
a 16-step tile, per-step shuffles); they are throwaway variants, never a
version of the kernel.

Prints the card's name and power limit, one line per shape and turn, and,
as its last line, a JSON object with every number; ``--out`` writes it too.
Needs a CUDA card and ``cuobjdump`` (on PATH or in ``$CUDA_HOME/bin``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the serve prefill rows of chip_smoke's timing phase: (B, S)
PREFILL_TIMED = {"prefill@B2_S1024": (2, 1024), "prefill@B1_S512": (1, 512)}
# the attention backward, causal: the LM train layer in bf16 (tensor cores)
# and qwen2's heads at B2 in fp32 (CUDA cores)
BWD_TIMED = (("attention_bwd@B8_S1024", (8, 1024, 12, 2, 128), "bfloat16"),
             ("attention_bwd_fp32@B2_S1024", (2, 1024, 12, 2, 128),
              "float32"))

# --probe: edits of the first backward (``scan_bwd_kernel``), each a list of
# (pattern, replacement) regular expressions that must match once
_NO_DBC = (r"        int idx;\n        const float tot = warp_sum8.*?\n        }\n"
           r"(?=        sh\.gp)", "")
_NO_STAGING = [(r"(    for \(int i = tid; i < TILE \* CHANNELS; i \+= THREADS\) "
                r"\{\n      const int j = i / CHANNELS, c = i % CHANNELS;\n)",
                r"    if (k == n_tiles - 1)\n\1"),
               (r"(    for \(int i = tid; i < TILE \* N; i \+= THREADS\) \{\n"
                r"      const int j = i / N, c = i % N;\n"
                r"      const long long t = t0 \+ j;\n)",
                r"    if (k == n_tiles - 1)\n\1")]
PROBES = {"as_is": [],
          "no_dbc_shuffles_stores": [_NO_DBC],
          "no_staging": _NO_STAGING,
          "no_dbc_no_staging": [_NO_DBC] + _NO_STAGING}

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "cuobjdump")


def parse_sass(text: str) -> dict:
    """{function name: [(address, instruction text), ...]} from
    ``cuobjdump -sass``; branch targets given as labels become addresses."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur.append((addr, m.group(2).strip()))
    for name, ins in funcs.items():
        funcs[name] = [(a, re.sub(r"`?\((\.L_x_\d+)\)`?",
                                  lambda m: hex(labels.get(m.group(1), -1)),
                                  t)) for a, t in ins]
    return funcs


def hot_loop(ins, op="MUFU.EX2") -> dict:
    """The loop with the most ``op`` instructions (the innermost of equals):
    its instructions without NOPs, its ``op`` count and their ratio, its
    shuffles and its 16-byte global loads."""
    best = None
    for addr, text in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target > addr:
            continue
        body = [t for a, t in ins if target <= a <= addr
                and not re.match(r"(@!?U?P\w+\s+)?NOP\b", t)]
        n = sum(op in t for t in body)
        key = (n, -len(body))
        if best is None or key > best[0]:
            best = (key, {"instructions": len(body), "op": op, "ops": n,
                          "instructions_per_op": len(body) / n
                          if n else None,
                          "shfl": sum("SHFL" in t for t in body),
                          "ldg_128": sum("LDG.E.128" in t for t in body),
                          "loop": [hex(target), hex(addr)]})
    return best[1] if best else {}


def sass_counts(lib: Path, kernel: str, op: str) -> dict:
    """Per instantiation of ``kernel`` in ``lib``: its hot loop by ``op``,
    and its instructions, ``op``s and 16-byte loads and stores in all."""
    text = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for name, ins in parse_sass(text).items():
        if kernel in name:
            out[name] = dict(hot_loop(ins, op), total_instructions=len(ins),
                             total_ops=sum(op in t for _, t in ins),
                             total_ldg_128=sum("LDG.E.128" in t
                                               for _, t in ins),
                             total_stg_128=sum("STG.E.128" in t
                                               for _, t in ins))
    return out


def scan_bwd_times(torch, cs, K, gen, dev, warm) -> dict:
    """The checkout's scan backward at ``SCAN_TRAIN`` (bf16 u, on the states
    its own saving forward wrote), B and C contiguous and as column views:
    device ms of its kernels, summed and each, and CUDA-event ms."""
    rows = {}
    ba, s, di, n = cs.SCAN_TRAIN
    for key, views in (("selective_scan_bwd", False),
                       ("selective_scan_bwd@bc_views", True)):
        sets = cs.scan_bwd_sets(torch, K, gen, dev, views)
        warm(sets[0], fn=K.selective_scan_bwd_cuda)
        per = {k: ms for k, (ms, _) in cs.device_kernels(
            torch, K.selective_scan_bwd_cuda, sets, iters=10).items()
            if "scan_bwd" in k}
        rows[key] = {"shape": [ba, s, di, n], "views": views,
                     "device_ms": sum(per.values()),
                     "kernels_ms": {cs.kernel_short_name(k): ms
                                    for k, ms in per.items()},
                     "ms": cs.time_ms(torch, K.selective_scan_bwd_cuda, sets,
                                      iters=10)}
        del sets
        torch.cuda.empty_cache()
    return rows


def worker(src: str, bwd_only: bool = False) -> dict:
    """Build and time the kernels of the checkout whose ``src/`` is ``src``
    (with ``bwd_only`` the scan's backward alone); ptxas's numbers and the
    SASS counts."""
    import torch
    sys.path[:0] = [src, str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan import kernel as K
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    if bwd_only:
        name = "selective_scan"
        logs = {name: (build._Build(name, build._target(name)).finish(), 0)}
    else:
        logs = build.build_all()
    ptxas = {n: cs.ptxas_summary(text) for n, (text, _) in logs.items()}
    # the (t, d, n) a thread of the backward walks a tile: a checkout before
    # the redesign has one channel a thread and no BWD_TILE
    per_trip = (getattr(K, "BWD_TILE", K.TILE) * getattr(K, "BWD_PAIR", 1)
                * K.STATES_PER_LANE)
    bwd_sass = sass_counts(build._target("selective_scan"), "scan_bwd_kernel",
                           "MUFU.EX2")
    for c in bwd_sass.values():
        c["elements_per_trip"] = per_trip
        c["exp_per_element"] = c.get("ops", 0) / per_trip
        c["instructions_per_element"] = c.get("instructions", 0) / per_trip
    rows = {}

    def warm(args, seconds=1.0, fn=K.selective_scan_cuda):
        """Run the kernel back to back for ``seconds``, so the card times at
        the clocks it holds under load, not at those of an idle start."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn(*args)
            torch.cuda.synchronize()

    rows.update(scan_bwd_times(torch, cs, K, gen, dev, warm))
    if bwd_only:
        return {"src": src, "times": rows, "ptxas": ptxas,
                "sass": bwd_sass}
    from repro_torch.kernels.flash_attention import kernel as FK
    for key, (ba, s, di, n) in cs.SCAN_TIMED.items():
        sets = []
        for _ in range(cs.n_sets(ba * s * di * 6)):
            u, dt, a, b, c, d, _ = cs.scan_inputs(torch, gen, dev, ba, s, di,
                                                  n)
            sets.append((u.to(torch.bfloat16), dt, a, b, c, d))
            del u
        warm(sets[0])
        rows[key] = {
            "shape": [ba, s, di, n],
            "device_ms": cs.device_ms(torch, K.selective_scan_cuda, sets,
                                      "scan_kernel"),
            "ms": cs.time_ms(torch, K.selective_scan_cuda, sets)}
        del sets
        torch.cuda.empty_cache()
    rows.update(cs.time_sil_mse(torch, dev, gen))
    for key, (b, s) in PREFILL_TIMED.items():
        per = 2 * (2 * b * s * cs.H * cs.D + 2 * b * s * cs.KV * cs.D)
        sets = [cs.prefill_inputs(torch, gen, dev, torch.bfloat16, s, s, b=b)
                for _ in range(cs.n_sets(per))]
        warm(sets[0], fn=FK.flash_attention_cuda)
        rows[key] = {
            "shape": [b, s, cs.H, cs.KV, cs.D],
            "device_ms": cs.device_ms(torch, FK.flash_attention_cuda, sets,
                                      "prefill"),
            "ms": cs.time_ms(torch, FK.flash_attention_cuda, sets)}
        del sets
        torch.cuda.empty_cache()
    def bwd(q, k, v, lse, do):
        return FK.flash_attention_bwd_cuda(q, k, v, lse, do, causal=True)

    for key, (b, s, h, kv, d), dn in BWD_TIMED:
        dtype = getattr(torch, dn)
        item = torch.finfo(dtype).bits // 8
        per = item * (3 * b * s * h * d + 4 * b * s * kv * d) + 4 * b * h * s
        sets = []
        for _ in range(cs.n_sets(per)):
            q, k, v = cs.prefill_inputs(torch, gen, dev, dtype, s, s, b=b,
                                        h=h, kv=kv)
            _, lse = FK.flash_attention_cuda(q, k, v, return_lse=True)
            sets.append((q, k, v, lse,
                         cs._rand(torch, gen, tuple(q.shape), dtype, dev)))
        warm(sets[0], fn=bwd)
        rows[key] = {
            "shape": [b, s, h, kv, d],
            "device_ms": cs.device_ms(torch, bwd, sets, "attn_bwd", iters=10),
            "ms": cs.time_ms(torch, bwd, sets, iters=10)}
        del sets
        torch.cuda.empty_cache()
    return {"src": src, "times": rows, "ptxas": ptxas,
            "sass": {**sass_counts(build._target("selective_scan"),
                                   "scan_kernel", "MUFU.EX2"), **bwd_sass,
                     **sass_counts(build._target("sil_mse"), "sil_mse",
                                   "LDG")}}


def run_worker(which: str, src: str, bwd_only: bool) -> dict:
    """One worker process on the checkout whose ``src/`` is ``src``; prints
    its log lines and times, and returns its report (None if it failed)."""
    proc = subprocess.run(
        [sys.executable, __file__, "--worker", src]
        + (["--bwd-only"] if bwd_only else []),
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        return None
    *said, last = proc.stdout.strip().splitlines()
    for line in said:                  # the worker's own log lines
        print(f"{which:5s} {line}", flush=True)
    res = json.loads(last)
    res["which"] = which
    for key, r in res["times"].items():
        extra = ""
        if "kernels_per_call" in r:
            extra = (f", {r['kernels_per_call']} kernels a call, floor "
                     f"{r['floor_ms']} ms")
        if "kernels_ms" in r:
            extra += " (" + ", ".join(f"{k} {ms:.4f}" for k, ms in
                                      r["kernels_ms"].items()) + ")"
        print(f"{which:5s} {key:28s} device {r['device_ms']:.4f} ms, "
              f"events {r['ms']:.4f} ms{extra}", flush=True)
        if "host_split_us" in r:
            print(f"{which:5s} {key:28s} host split (us a call): "
                  + ", ".join(f"{k} {v:.2f}"
                              for k, v in r["host_split_us"].items()),
                  flush=True)
    return res


def print_build(which: str, res: dict) -> None:
    for name, c in res["sass"].items():
        per = (f"; {c['elements_per_trip']} elements a trip: "
               f"{c['exp_per_element']:.3f} exponentials and "
               f"{c['instructions_per_element']:.2f} instructions each"
               if "elements_per_trip" in c else "")
        print(f"{which:5s} SASS {name}: hot loop {c.get('instructions')}"
              f" instructions, {c.get('ops')} {c.get('op')} "
              f"({c.get('instructions_per_op')} instructions each), "
              f"{c.get('shfl')} SHFL, {c.get('ldg_128')} LDG.E.128{per}; in "
              f"all {c['total_instructions']} instructions, "
              f"{c['total_ldg_128']} LDG.E.128, {c['total_stg_128']} "
              "STG.E.128", flush=True)
    for lib in res["ptxas"].values():
        for kern, c in lib.items():
            if "scan" in kern:
                print(f"{which:5s} ptxas {kern}: {c}", flush=True)


def probe_copy(other: Path, name: str, edits) -> Path:
    """A copy of ``other``'s ``src/`` under ``build/probe/<name>/`` with
    ``edits`` made to its ``selective_scan.cu``."""
    root = ROOT / "build" / "probe" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(other / "src", root / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / "src" / "repro_torch" / "kernels" / "csrc" / \
        "selective_scan.cu"
    text = cu.read_text()
    for pat, rep in edits:
        text, n = re.subn(pat, rep, text, flags=re.S)
        if n != 1:
            raise SystemExit(f"probe {name}: {pat!r} matched {n} times")
    cu.write_text(text)
    return root / "src"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--out", default=None)
    ap.add_argument("--probe", action="store_true",
                    help="time edited copies of the other checkout's "
                         "backward (PROBES) instead of the A/B turns")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--bwd-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.bwd_only)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.other or not (Path(args.other) / "src").is_dir():
        ap.error("--other must be a checkout with src/")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    card = cs.smi_line()
    print(card, flush=True)
    other = Path(args.other).resolve()
    turns = []
    if args.probe:
        for name, edits in PROBES.items():
            res = run_worker(name, str(probe_copy(other, name, edits)), True)
            if res is None:
                return 1
            turns.append(res)
        for res in turns:
            print_build(res["which"], res)
    else:
        trees = {"other": str(other / "src"), "this": str(ROOT / "src")}
        for which in ("other", "this", "this", "other"):
            res = run_worker(which, trees[which], False)
            if res is None:
                return 1
            turns.append(res)
        for which in ("other", "this"):
            print_build(which, next(t for t in turns if t["which"] == which))
    report = {"card": card, "turns": turns}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
