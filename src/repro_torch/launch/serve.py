"""Serving launcher: thin CLI over ``repro_torch.serve.Engine``.

Runs on the card by default (``--device cuda`` raises when torch sees no
CUDA device); ``--device cpu`` runs the plain PyTorch path.
``--stages N`` (N > 1) slices the weights into the PartitionPlan's N
uniform stages and serves them unjoined (``Engine(plan=, stage_params=)``).
Every ``--arch`` of ``configs.ARCH_NAMES`` serves, the mixture-of-experts
ones (granite-moe-3b-a800m, Jamba) with their experts; whisper-tiny's
synthetic requests carry no frames, so the engine encodes its zero stub
(as the reference's CLI does), and llava-next-34b's carry no image, so the
engine prepends the projection of its zero image rows the same way.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      [--smoke] [--device cuda|cpu] [--paged] [--precision bf16] \
      [--batch 4 --prompt-len 64 --new-tokens 32] [--window 256] \
      [--slots 4] [--stages 2] [--temperature 0.8 --top-k 40 --top-p 0.95]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get
from repro_torch.core import partition
from repro_torch.data.lm import synthetic_token_stream
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Engine, GenerationConfig, Request


def build_engine(cfg, params, args, device):
    """The engine in joined or PartitionPlan-staged mode (--stages > 1)."""
    kw = dict(device=device, max_slots=args.slots,
              decode_block=args.decode_block, precision=args.precision,
              paged=args.paged)
    if args.stages > 1:
        plan = partition.make_plan(cfg, args.stages)
        stage_params = [partition.slice_stage_params(cfg, plan, params, k)
                        for k in range(plan.n_stages)]
        return Engine(cfg, plan=plan, stage_params=stage_params, **kw)
    return Engine(cfg, params, **kw)


def synthetic_requests(cfg, args) -> list:
    stream = synthetic_token_stream(args.batch * args.prompt_len + 1,
                                    cfg.vocab_size, seed=0)
    prompts = stream[: args.batch * args.prompt_len].reshape(args.batch, -1)
    gen = GenerationConfig(max_new_tokens=args.new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p)
    return [Request(tokens=prompts[i], gen=gen, id=f"req-{i}")
            for i in range(args.batch)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--paged", action="store_true",
                    help="serve from the block-paged cache pool")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--slots", type=int, default=0,
                    help="concurrent cache slots (0 = one per request)")
    ap.add_argument("--decode-block", type=int, default=16,
                    help="decode steps between scheduler events")
    ap.add_argument("--stages", type=int, default=1,
                    help=">1 serves the PartitionPlan stages unjoined")
    ap.add_argument("--precision", default=None,
                    choices=["fp32", "bf16", "fp16"],
                    help="serving precision policy (default: the arch "
                         "config's dtype)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)
    args.slots = args.slots or args.batch

    device = resolve_device(args.device)
    cfg = get(args.arch, smoke=args.smoke)
    if args.window:
        cfg = cfg.replace(sliding_window=args.window)
    params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    engine = build_engine(cfg, params, args, device)
    del params
    requests = synthetic_requests(cfg, args)

    t0 = time.perf_counter()
    outs = engine.generate(requests)
    dt = time.perf_counter() - t0
    n = sum(c.n_generated for c in outs)
    pool = engine._pool
    cache_note = "" if pool is None else \
        f", cache={pool.nbytes/2**20:.1f}MiB@{engine.cfg.dtype}"
    print(f"decoded {n} tokens in {dt*1e3:.0f}ms -> {n/dt:.0f} tok/s "
          f"on {device} (requests={args.batch}, slots={args.slots}, "
          f"paged={args.paged}, stages={args.stages}, "
          f"window={cfg.sliding_window or 'full'}"
          f"{cache_note})")
    print("sample:", list(outs[0].tokens[:16]))


if __name__ == "__main__":
    main()
