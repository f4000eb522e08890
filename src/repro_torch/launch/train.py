"""Training launcher (counterpart of ``repro/launch/train.py``).

Runs on the card by default (``--device cuda`` raises when torch sees no
CUDA device); ``--device cpu`` runs the plain PyTorch path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      [--smoke] --mode pnn --stages 2 [--steps 20 --batch 8 --seq 128] \
      [--lr 3e-4] [--precision fp32|bf16|fp16] [--accum 1] [--device cpu]

``--mode pnn`` on an LM arch is the stage-sequential schedule with the
reference's spec: every stage ``steps // n_stages`` AdamW steps, the last
with CE on the live frozen prefix, then ``steps // 4`` steps of §5 recovery
at ``lr / 10``; SIL kappa 1.0.  ``--arch paper_mlp --mode baseline`` trains
the paper's MLP end to end (``--steps`` epochs).  Not ported yet, and
raising with their ROADMAP row: ``--mode baseline`` on an LM arch (the
sharded train step of ``launch/steps.py``), ``--mode pnn`` on the paper MLP
(the Fig.-5 parallel recipe), ``--stages auto`` (``repro.plan``), ``--dist``
and ``--devices`` (stage placement), ``--seq-shard`` (the production mesh),
``--resume`` and ``--ckpt-dir`` (checkpoints).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get
from repro_torch.data.lm import lm_batches, synthetic_token_stream
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as M
from repro_torch.train import StageSpec, TrainSpec, recipes


def parse_stages(text: str) -> int:
    """``--stages``: a count; the reference's ``auto[:K]`` raises."""
    if text.startswith("auto"):
        raise NotImplementedError(
            "--stages auto: the repro.plan searched cut is not ported yet "
            "(ROADMAP queue A, operations: plan/search.py); pass a count")
    return int(text)


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
                    help="PNN partition count (uniform split)")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--precision", default=None,
                    choices=["fp32", "bf16", "fp16"],
                    help="precision policy (default: the arch config's "
                         "dtype)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--dist", default="none",
                    choices=["none", "round_robin", "memory"])
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.dist != "none" or args.devices:
        raise NotImplementedError(
            "--dist / --devices: stage placement across devices is not "
            "ported yet (ROADMAP queue A, parallel stages: dist/placement.py,"
            " dist/executor.py)")
    if args.resume or args.ckpt_dir:
        raise NotImplementedError(
            "--resume / --ckpt-dir: checkpoints are not ported yet (ROADMAP "
            "queue A, parallel stages and durability: checkpoint/"
            "checkpoint.py)")
    if args.seq_shard:
        raise SystemExit(
            "--seq-shard needs the production mesh, which the port does not "
            "have (ROADMAP queue A, last: launch/{sharding,mesh}.py as "
            "DeviceMesh/DTensor)")
    n_stages = parse_stages(args.stages)
    device = resolve_device(args.device)
    if args.arch == "paper_mlp":
        return _run_paper_mlp(args, device)
    if args.mode != "pnn":
        raise NotImplementedError(
            "--mode baseline on an LM arch needs the sharded train step of "
            "launch/steps.py, which is not ported yet (ROADMAP queue A, "
            "operations: launch steps CLI); use --mode pnn")

    cfg = get(args.arch, smoke=args.smoke)
    print(f"arch={cfg.name} device={device} precision="
          f"{args.precision or cfg.dtype}")
    stream = synthetic_token_stream(1_000_000, cfg.vocab_size, seed=0)
    it = lm_batches(stream, args.batch, args.seq, seed=0)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    plan = recipes.resolve_plan(cfg, n_stages)
    print(f"plan[uniform]: {plan.n_stages} stages, bounds {plan.bounds}")
    t0 = time.perf_counter()
    params, hist = recipes.run_lm_sequential(
        cfg, plan, params, lambda _: next(it), lm_spec(args, n_stages),
        torch.Generator(device=device).manual_seed(1), device=device)
    losses = hist.column("loss")
    print(f"{len(losses)} steps in {time.perf_counter() - t0:.1f}s")
    print("PNN losses (tail):", [round(v, 3) for v in losses[-5:]])
    return params, hist


def _run_paper_mlp(args, device):
    """The paper's EMNIST MLP through the same CLI: end-to-end baseline
    (``--steps`` epochs)."""
    from repro_torch.configs import paper_mlp
    from repro_torch.data.images import emnist_like
    from repro_torch.train.backends import mlp_test_accuracy
    if args.mode != "baseline":
        raise NotImplementedError(
            "--arch paper_mlp --mode pnn runs the Fig.-5 parallel recipe in "
            "the reference, which is not ported yet (ROADMAP queue A, "
            "parallel stages: run_mlp_fig5)")
    cfg = paper_mlp.smoke() if args.smoke else paper_mlp.CONFIG
    n_train, n_test = (9400, 940) if args.smoke else (28200, 2820)
    data = emnist_like(n_train=n_train, n_test=n_test, seed=0, noise=0.5)
    spec = TrainSpec(
        batch_size=1410, kappa=10.0, shuffle=True, precision=args.precision,
        baseline=StageSpec(epochs=args.steps, lr=0.01, optimizer="sgdm",
                           momentum=0.9))
    params, hist = recipes.run_mlp_baseline(
        cfg, data, spec, torch.Generator(device=device).manual_seed(0),
        device=device)
    x, y = (torch.as_tensor(a).to(device) for a in data[2:])
    acc = mlp_test_accuracy(cfg, params, x.float(), y.long())
    print(f"paper_mlp baseline: test acc {acc:.4f}")
    return params, hist


if __name__ == "__main__":
    main()
