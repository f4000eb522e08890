"""Training launcher (counterpart of ``repro/launch/train.py``).

Runs on the card by default (``--device cuda`` raises when torch sees no
CUDA device); ``--device cpu`` runs the plain PyTorch path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      [--smoke] --mode pnn --stages 2|auto|auto:K \
      [--steps 20 --batch 8 --seq 128] \
      [--lr 3e-4] [--precision fp32|bf16|fp16] [--accum 1] [--device cpu] \
      [--dist round_robin|memory [--devices N]] [--ckpt-dir D \
      [--ckpt-every T]] [--resume D]

``--mode pnn`` on an LM arch is the stage-sequential schedule with the
reference's spec: every stage ``steps // n_stages`` AdamW steps, the last
with CE on the live frozen prefix, then ``steps // 4`` steps of §5 recovery
at ``lr / 10``; SIL kappa 1.0.  With ``--dist`` it is Fig. 5 instead
(``run_lm_parallel``): every stage ``--steps`` steps at once, placed over
``--devices`` cards (default: one per stage, as many as there are; on
``--device cpu`` the CPU stands in for each) by the ``repro_torch.dist``
executor, on batches that are a pure function of the step, with per-stage
checkpoints under ``<ckpt-dir>/stages`` every ``--ckpt-every`` ticks.
``--ckpt-dir`` also saves the whole model at the end; ``--resume D`` starts
an LM from D's latest params.  ``--arch paper_mlp`` trains the paper's MLP
(``--steps`` epochs): ``--mode baseline`` end to end, ``--mode pnn`` Fig. 5
(``run_mlp_fig5``, optionally with ``--dist``) after printing each stage's
cost row.  ``--stages`` accepts a count (uniform split), ``auto``
(cost-model searched boundaries via ``repro_torch.plan``, default K=2), or
``auto:K``, for an LM arch and the paper's MLP alike.  Not ported yet, and
raising with their ROADMAP row: ``--mode baseline`` on an LM arch (the
sharded train step of ``launch/steps.py``), ``--seq-shard`` (the production
mesh).  An encoder-decoder or a vision config is refused: the CLI's token
stream carries no frames or image embeddings (nor does the reference's).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCH_NAMES, get
from repro_torch.core import partition
from repro_torch.data.lm import lm_batch_at, lm_batches, synthetic_token_stream
from repro_torch.dist import stage_devices
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as M
from repro_torch.plan import parse_stages
from repro_torch.train import StageSpec, TrainSpec, recipes


def lm_spec(args, n_stages: int) -> TrainSpec:
    """The reference launcher's sequential PNN spec."""
    return TrainSpec(
        n_stages=n_stages, kappa=1.0, precision=args.precision,
        stages=tuple(StageSpec(steps=args.steps // n_stages, lr=args.lr,
                               optimizer="adamw", accum=args.accum)
                     for _ in range(n_stages)),
        recovery=StageSpec(steps=args.steps // 4, lr=args.lr / 10,
                           optimizer="adamw", accum=args.accum))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=ARCH_NAMES + ["paper_mlp"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20,
                    help="LM: optimizer steps; paper_mlp: epochs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", default="baseline", choices=["baseline", "pnn"])
    ap.add_argument("--stages", default="2",
                    help="PNN partition count: N (uniform split), 'auto' "
                         "(cost-model searched cut, K=2), or 'auto:K'")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--precision", default=None,
                    choices=["fp32", "bf16", "fp16"],
                    help="precision policy (default: the arch config's "
                         "dtype)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="per-stage checkpoint cadence in ticks (--dist; "
                         "0 = at the end only)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to restore an LM's params from "
                         "(latest step) before training")
    ap.add_argument("--dist", default="none",
                    choices=["none", "round_robin", "memory"],
                    help="PNN stage placement: Fig. 5 through the "
                         "repro_torch.dist executor (needs --mode pnn)")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to place the stages over (default: one "
                         "per stage, as many as there are)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.dist != "none" and args.mode != "pnn":
        raise SystemExit("--dist requires --mode pnn (stage placement only "
                         "exists for partitioned training)")
    if args.seq_shard:
        raise SystemExit(
            "--seq-shard needs the production mesh, which the port does not "
            "have (ROADMAP queue A, last: launch/{sharding,mesh}.py as "
            "DeviceMesh/DTensor)")
    strategy, n_stages = parse_stages(args.stages)
    device = resolve_device(args.device)
    if args.arch == "paper_mlp":
        return _run_paper_mlp(args, strategy, n_stages, device)
    if args.mode != "pnn":
        raise NotImplementedError(
            "--mode baseline on an LM arch needs the sharded train step of "
            "launch/steps.py, which is not ported yet (ROADMAP queue A, "
            "operations: launch steps CLI); use --mode pnn")

    cfg = get(args.arch, smoke=args.smoke)
    if cfg.enc_dec:
        raise SystemExit(
            f"{cfg.name} is an encoder-decoder: its batches need frames, "
            "which the CLI's token stream does not carry (nor the "
            "reference's); train it through train.recipes with a batch_fn "
            "that gives them")
    if cfg.frontend == "vision":
        raise SystemExit(
            f"{cfg.name} is a vision config: its batches need image_embeds, "
            "which the CLI's token stream does not carry (nor the "
            "reference's); train it through train.recipes with a batch_fn "
            "that gives them")
    print(f"arch={cfg.name} device={device} precision="
          f"{args.precision or cfg.dtype}")
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    step0 = 0
    if args.resume:
        step0 = latest_step(args.resume) or 0
        params = restore_checkpoint(args.resume, {"params": params},
                                    device=device)["params"]
        print(f"resumed params from {args.resume} @ step {step0} "
              f"(training continues to step {step0 + args.steps})")
    plan = partition.make_plan(cfg, n_stages, strategy=strategy)
    _print_plan(strategy, plan)
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    if args.dist != "none":
        devs = _dist_devices(args, n_stages, device)
        spec = TrainSpec(
            n_stages=n_stages, kappa=1.0, precision=args.precision,
            stages=tuple(StageSpec(steps=args.steps, lr=args.lr,
                                   optimizer="adamw", accum=args.accum)
                         for _ in range(n_stages)))
        ckpt_dir = os.path.join(args.ckpt_dir, "stages") \
            if args.ckpt_dir else None

        def batch_at(i):
            # a pure function of the tick, not the shared iterator: a
            # resumed stage replaying ticks t..n sees the batches the other
            # stages saw at those ticks
            return lm_batch_at(stream, args.batch, args.seq, i)
        params, hist = recipes.run_lm_parallel(
            cfg, plan, params, batch_at, spec, gen, dist=args.dist,
            dist_devices=devs, ckpt_dir=ckpt_dir,
            ckpt_every=args.ckpt_every, device=device)
        label = f"dist={args.dist} over {len(devs)} devices; PNN parallel"
    else:
        it = lm_batches(stream, args.batch, args.seq, seed=0)
        params, hist = recipes.run_lm_sequential(
            cfg, plan, params, lambda _: next(it), lm_spec(args, n_stages),
            gen, device=device)
        label = "PNN"
    losses = hist.column("loss")
    print(f"{len(losses)} steps in {time.perf_counter() - t0:.1f}s")
    print(f"{label} losses (tail):", [round(v, 3) for v in losses[-5:]])
    _save(args, step0 + args.steps, params)
    return params, hist


def _print_plan(strategy: str, plan) -> None:
    if strategy == "auto":
        print(f"plan[auto]: {plan.n_stages} stages, searched bounds "
              f"{plan.bounds} (repro_torch.plan cost-model cut)")
    else:
        print(f"plan[uniform]: {plan.n_stages} stages, bounds {plan.bounds}")


def _dist_devices(args, n_stages: int, device):
    """The devices ``--dist`` places the stages over: ``--devices`` of
    them, default one per stage as far as there are cards (the CPU stands
    in for each on ``--device cpu``)."""
    n = args.devices
    if not n:
        have = n_stages if device.type == "cpu" \
            else torch.cuda.device_count()
        n = min(n_stages, have)
    return stage_devices(n, device)


def _save(args, step: int, params) -> None:
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, step, {"params": params})
        print("saved:", path)


def _run_paper_mlp(args, strategy: str, n_stages: int, device):
    """The paper's EMNIST MLP through the same CLI: the end-to-end baseline,
    or Fig. 5 over ``n_stages`` stages with uniform (the paper's cut at 2)
    or searched bounds (``--steps`` epochs either way)."""
    from repro_torch import plan as plan_lib
    from repro_torch.configs import paper_mlp
    from repro_torch.data.images import emnist_like
    from repro_torch.train.backends import (mlp_default_bounds,
                                            mlp_test_accuracy)
    cfg = paper_mlp.smoke() if args.smoke else paper_mlp.CONFIG
    n_train, n_test = (9400, 940) if args.smoke else (28200, 2820)
    data = emnist_like(n_train=n_train, n_test=n_test, seed=0, noise=0.5)
    sgdm = dict(epochs=args.steps, lr=0.01, optimizer="sgdm", momentum=0.9)
    spec = TrainSpec(
        batch_size=1410, kappa=10.0, shuffle=True, n_stages=n_stages,
        precision=args.precision,
        stages=tuple(StageSpec(**sgdm) for _ in range(n_stages)),
        baseline=StageSpec(**sgdm))
    gen = torch.Generator(device=device).manual_seed(0)
    if args.mode == "baseline":
        params, hist = recipes.run_mlp_baseline(cfg, data, spec, gen,
                                                device=device)
    else:
        if strategy == "auto":
            bounds = plan_lib.auto_mlp_bounds(cfg, n_stages,
                                              batch_size=spec.batch_size)
        else:
            bounds = mlp_default_bounds(cfg, n_stages)
        print(f"plan[{strategy}]: {n_stages} stages, bounds {bounds}")
        for c in plan_lib.mlp_costs(
                cfg, batch_size=spec.batch_size).stage_costs(bounds):
            print(f"  stage{c.stage}: layers[{c.lo},{c.hi}) "
                  f"bytes={c.bytes_total:,} flops={c.flops:.3g}")
        dist = None if args.dist == "none" else args.dist
        params, hist = recipes.run_mlp_fig5(
            cfg, data, spec, gen, n_stages=n_stages, bounds=bounds,
            dist=dist, device=device,
            dist_devices=_dist_devices(args, n_stages, device) if dist
            else None)
    x, y = (torch.as_tensor(a).to(device) for a in data[2:])
    acc = mlp_test_accuracy(cfg, params, x.float(), y.long())
    print(f"paper_mlp {args.mode}: test acc {acc:.4f}")
    _save(args, args.steps, params)
    return params, hist


if __name__ == "__main__":
    main()
