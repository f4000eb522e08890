"""Multi-pod dry run on the meta device (counterpart of
``repro/launch/dryrun.py``): for every (arch x input-shape x mesh)
combination, take the shapes of the step it would run from meta-tensor
stand-ins (``launch/specs.py``; no storage, no card) and estimate its
roofline terms per chip under the sharding policy (``launch/sharding.py``) on the abstract
production mesh (``launch/mesh.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--mode pnn]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json

Results are cached in the output JSON (``results/dryrun_torch.json`` by
default, beside the reference's ``results/dryrun.json``, whose cached keys
it would otherwise read as its own); finished combinations are skipped
unless --force is given.

The records carry the reference's keys.  The reference lowers and compiles
each step with XLA and reads the compiled artifact (``memory_analysis``,
``hlo_raw``, the loop-aware ``collectives``); the port has no whole-program
compiler, so those are null, ``no_artifact`` says why, ``collective_s`` is
null and ``dominant`` picks from compute and memory.  The optimizer and
the microbatch count are those ``launch/steps.py`` picks
(``pick_optimizer_name``, ``pick_accum``); no step is built or run: the
estimates read shapes alone.  ``--seq-shard``,
``--rec-shard`` and ``--moe-local`` constrain tensors on a mesh of cards
and raise.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import ARCH_NAMES, get
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core import partition
from repro_torch.launch import specs as S
from repro_torch.launch.hlo_analysis import (analytic_flops_per_chip,
                                             analytic_hbm_bytes_per_chip,
                                             tree_bytes_per_chip)
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh, mesh_refusal)
from repro_torch.launch.sharding import Policy
from repro_torch.launch.steps import pick_accum, pick_optimizer_name
from repro_torch.models import model as M
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_map

NO_ARTIFACT = ("no compiled artifact: the port runs eager PyTorch, with no "
               "whole-program compiler whose memory analysis, cost analysis "
               "or collectives could be read")


def analyze(cfg, shape, n_chips, *, params_bytes=0, opt_bytes=0,
            cache_bytes=0, accum=1) -> Dict[str, Any]:
    """Roofline terms: analytic compute and memory.  Where the reference
    reads the compiled artifact (``memory_analysis``, ``hlo_raw``,
    ``collectives``), the record holds null and ``no_artifact``."""
    flops = analytic_flops_per_chip(cfg, shape, n_chips)
    hbm = analytic_hbm_bytes_per_chip(
        cfg, shape, n_chips, params_bytes_per_chip=params_bytes,
        opt_bytes_per_chip=opt_bytes, cache_bytes_per_chip=cache_bytes,
        accum=accum)
    out = {
        "analytic_flops_per_chip": flops,
        "analytic_hbm_bytes_per_chip": hbm,
        "collectives": None,
        "memory_analysis": None,
        "hlo_raw": None,
        "no_artifact": NO_ARTIFACT,
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": hbm / HBM_BW,
        "collective_s": None,
    }
    terms = {k: out[k] for k in ("compute_s", "memory_s")}
    out["dominant"] = max(terms, key=terms.get)
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*tokens (train), 2*N_active*tokens (prefill),
    2*N_active*B (decode, per step)."""
    n = cfg.param_counts()["active"] - cfg.param_counts()["embed"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def meta_params(cfg):
    """``init_params``' tree on the meta device: shapes and dtypes only; a
    fresh tree each call, its meta tensors (which hold no data) built once
    a config: building them goes through torch's reference decompositions,
    most of the sweep's time."""
    return tree_map(lambda t: t, _meta_params(cfg))


@functools.lru_cache(maxsize=None)
def _meta_params(cfg):
    return M.init_params(cfg, torch.Generator(), device=S.META)


# --------------------------------------------------------------------------

def dryrun_one(arch: str, shape_name: str, *, multi_pod=False, mode="baseline",
               seq_shard=False, rec_shard=False, accum_override=None,
               moe_local=False, mesh_shape=None, precision=None,
               pnn_stages=2, pnn_strategy="uniform", dist_devices=None,
               verbose=True) -> Dict[str, Any]:
    for flag, on in (("--seq-shard", seq_shard), ("--rec-shard", rec_shard),
                     ("--moe-local", moe_local)):
        if on:
            raise ValueError(mesh_refusal(flag))
    shape = INPUT_SHAPES[shape_name]
    if arch == "paper_mlp":
        return _dryrun_mlp(shape_name, pnn_strategy, pnn_stages, mode=mode)
    cfg0 = get(arch)
    ok, reason = S.applicable(cfg0, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mode": mode, "seq_shard": seq_shard, "rec_shard": rec_shard,
    }
    if precision is not None:
        rec["precision"] = precision
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    cfg = S.arch_for_shape(cfg0, shape)
    if precision is not None:
        # re-dtype the compute path (activations / caches / boundary
        # streams); the analytic byte model and init_cache both follow
        # cfg.dtype, so every downstream estimate is policy-aware
        from repro_torch.precision import get_policy
        cfg = get_policy(precision).apply_to_model(cfg)
    if mode == "pipeline" and not multi_pod:
        multi_pod = True  # pipeline baseline = stage-per-pod on 2 pods
        rec["multi_pod"] = True
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    n_chips = mesh.size
    policy = Policy(cfg, mesh, pipeline=(mode == "pipeline"))
    t0 = time.time()

    params_struct = meta_params(cfg)
    p_sh = policy.params_pspecs(params_struct)

    if shape.kind == "train" and mode in ("baseline", "pipeline"):
        rec.update(_lower_train(cfg, shape, mesh, policy, params_struct,
                                p_sh, accum_override))
    elif shape.kind == "train" and mode == "pnn":
        rec.update(_lower_pnn(cfg, shape, mesh, policy, params_struct,
                              n_stages=pnn_stages, strategy=pnn_strategy,
                              dist_devices=dist_devices))
    elif shape.kind == "prefill":
        rec.update(_lower_prefill(cfg, shape, mesh, policy, params_struct,
                                  p_sh))
    else:
        rec.update(_lower_decode(cfg, shape, mesh, policy, params_struct,
                                 p_sh))

    rec["n_chips"] = n_chips
    rec["elapsed_s"] = round(time.time() - t0, 1)
    rec["sharding_decisions"] = policy.explain()
    mf = model_flops(cfg, shape)
    rec["model_flops_per_chip"] = mf / n_chips
    if rec.get("analysis", {}).get("analytic_flops_per_chip"):
        rec["useful_flops_ratio"] = (mf / n_chips) / \
            rec["analysis"]["analytic_flops_per_chip"]
    rec["params_bytes_per_chip"] = tree_bytes_per_chip(params_struct, p_sh,
                                                      mesh)
    rec["status"] = "ok"
    return rec


def _lower_train(cfg, shape, mesh, policy, params_struct, p_sh,
                 accum_override=None):
    opt_name = pick_optimizer_name(cfg)
    opt = make_optimizer(opt_name, 1e-3)
    accum = accum_override or pick_accum(cfg, shape, policy)
    ostate_struct = opt.init(params_struct)
    o_sh = policy.opt_state_pspecs(opt_name, params_struct)
    pbytes = tree_bytes_per_chip(params_struct, p_sh, mesh)
    obytes = tree_bytes_per_chip(ostate_struct, o_sh, mesh)
    return {"optimizer": opt_name, "accum": accum,
            "opt_bytes_per_chip": obytes,
            "analysis": analyze(cfg, shape, mesh.size, params_bytes=pbytes,
                                opt_bytes=obytes, accum=accum)}


def _lower_prefill(cfg, shape, mesh, policy, params_struct, p_sh):
    cache_struct = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                device=S.META)
    c_sh = policy.cache_pspecs(cache_struct, shape.global_batch)
    pbytes = tree_bytes_per_chip(params_struct, p_sh, mesh)
    cbytes = tree_bytes_per_chip(cache_struct, c_sh, mesh)
    return {"cache_bytes_per_chip": cbytes,
            "analysis": analyze(cfg, shape, mesh.size, params_bytes=pbytes,
                                cache_bytes=cbytes)}


def _lower_decode(cfg, shape, mesh, policy, params_struct, p_sh):
    cache_struct, _, _ = S.decode_specs(cfg, shape)
    c_sh = policy.cache_pspecs(cache_struct, shape.global_batch)
    pbytes = tree_bytes_per_chip(params_struct, p_sh, mesh)
    cbytes = tree_bytes_per_chip(cache_struct, c_sh, mesh)
    return {"cache_bytes_per_chip": cbytes,
            "analysis": analyze(cfg, shape, mesh.size, params_bytes=pbytes,
                                cache_bytes=cbytes)}


def _lower_pnn(cfg, shape, mesh, policy, params_struct, n_stages=2,
               strategy="uniform", dist_devices=None):
    """Every PNN stage's estimate and its per-stage bytes.

    This is the paper's claim in numbers: each stage's step touches only
    that stage's params and optimizer state, and stages train with zero
    inter-stage collectives (the pod axis carries nothing during training).

    strategy="auto" cuts via the ``repro_torch.plan`` searcher and attaches
    the chosen cuts + predicted per-stage bytes/FLOPs next to the per-stage
    estimates.

    dist_devices: also report the memory-balanced ``repro_torch.dist``
    placement of the stages onto that many devices, packed by these same
    per-stage byte numbers.
    """
    opt_name = pick_optimizer_name(cfg)
    plan = partition.make_plan(cfg, n_stages, strategy=strategy,
                               **({"optimizer": opt_name}
                                  if strategy == "auto" else {}))
    plan_rec = _predicted_plan(cfg, plan, strategy, opt_name)
    stages = []
    for k in range(plan.n_stages):
        opt = make_optimizer(opt_name, 1e-3)
        sp_struct = partition.slice_stage_params(cfg, plan, params_struct, k)
        sp_sh = policy.params_pspecs(sp_struct)
        so_struct = opt.init(sp_struct)
        so_sh = policy.opt_state_pspecs(opt_name, sp_struct)
        spb = tree_bytes_per_chip(sp_struct, sp_sh, mesh)
        sob = tree_bytes_per_chip(so_struct, so_sh, mesh)
        stages.append({
            "stage": k,
            "analysis": analyze(cfg, shape, mesh.size, params_bytes=spb,
                                opt_bytes=sob),
            "stage_params_bytes_per_chip": spb,
            "stage_opt_bytes_per_chip": sob,
        })
    out = {"optimizer": opt_name, "pnn_stages": stages,
           "n_stages": plan.n_stages, "plan": plan_rec}
    if dist_devices:
        # pack stages onto a smaller device set by the byte estimates just
        # computed — the plan repro_torch.dist's "memory" strategy would pick
        from repro_torch.dist.placement import memory_balanced
        per_stage = [s["stage_params_bytes_per_chip"]
                     + s["stage_opt_bytes_per_chip"] for s in stages]
        pl = memory_balanced(per_stage, devices=tuple(range(dist_devices)))
        out["placement"] = {"strategy": pl.strategy,
                            "assignments": list(pl.assignments),
                            "loads_bytes": list(pl.loads)}
    return out


def _predicted_plan(cfg, plan, strategy, opt_name):
    """The ``repro_torch.plan`` side of the PNN record: chosen cuts + the
    cost model's predicted per-stage bytes/FLOPs, printed next to the
    per-stage estimates.

    Predictions use the searcher's default SIL workload (DEFAULT_BATCH x
    DEFAULT_SEQ — per-stage training batches, not the pretrain shape), the
    same table ``make_plan(strategy="auto")`` optimized over."""
    from repro_torch import plan as plan_lib
    table = plan_lib.lm_costs(cfg, optimizer=opt_name)
    rows = table.stage_costs(plan.bounds)
    return {
        "strategy": strategy,
        "bounds": [list(b) for b in plan.bounds],
        "cuts": [int(hi) for _, hi in plan.bounds[:-1]],
        "cost_batch": plan_lib.DEFAULT_BATCH,
        "cost_seq": plan_lib.DEFAULT_SEQ,
        "predicted_stages": [c.row() for c in rows],
        "predicted_imbalance": round(plan_lib.predicted_imbalance(rows), 6),
        "predicted_bottleneck_bytes": int(max(c.bytes_total for c in rows)),
    }


def _dryrun_mlp(shape_name: str, strategy: str, n_stages: int,
                mode: str = "pnn"):
    """Paper-MLP dry run: no mesh (the MLP trains on one host) — report the
    chosen stage bounds + predicted per-stage bytes/FLOPs from the same
    ``repro_torch.plan`` cost table the train CLI and auto-searcher use."""
    rec: Dict[str, Any] = {"arch": "paper_mlp", "shape": shape_name,
                           "mode": mode}
    shape = INPUT_SHAPES[shape_name]
    if shape.kind != "train":
        rec["status"] = "skipped"
        rec["reason"] = "paper_mlp only trains (no prefill/decode shapes)"
        return rec
    if mode != "pnn":
        rec["status"] = "skipped"
        rec["reason"] = "paper_mlp dry-run reports the PNN plan; " \
                        "use --mode pnn"
        return rec
    from repro_torch import plan as plan_lib
    from repro_torch.configs import paper_mlp
    from repro_torch.train.backends import mlp_default_bounds
    t0 = time.time()
    cfg = paper_mlp.CONFIG
    table = plan_lib.mlp_costs(cfg)
    if strategy == "auto":
        bounds = plan_lib.auto_bounds(table, n_stages)
    else:
        bounds = mlp_default_bounds(cfg, n_stages)
    rows = table.stage_costs(bounds)
    rec["n_stages"] = n_stages
    rec["optimizer"] = table.optimizer
    rec["plan"] = {
        "strategy": strategy,
        "bounds": [list(b) for b in bounds],
        "cuts": [int(hi) for _, hi in bounds[:-1]],
        "predicted_stages": [c.row() for c in rows],
        "predicted_imbalance": round(plan_lib.predicted_imbalance(rows), 6),
        "predicted_bottleneck_bytes": int(max(c.bytes_total for c in rows)),
    }
    rec["n_chips"] = 1
    rec["elapsed_s"] = round(time.time() - t0, 1)
    rec["status"] = "ok"
    return rec


def _ms(x) -> str:
    return "n/a" if x is None else f"{x * 1e3:.2f}ms"


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    choices=ARCH_NAMES + ["all", "paper_mlp"])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "pnn", "pipeline"])
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel residual sharding (needs a mesh "
                         "of cards: raises)")
    ap.add_argument("--rec-shard", action="store_true",
                    help="pin recurrent scan carries to batch sharding "
                         "(needs a mesh of cards: raises)")
    ap.add_argument("--accum", type=int, default=None,
                    help="override microbatch count (perf variant)")
    ap.add_argument("--moe-local", action="store_true",
                    help="locality-grouped MoE dispatch (needs a mesh of "
                         "cards: raises)")
    ap.add_argument("--mesh", default=None,
                    help="pod mesh shape override, e.g. 32x8 (perf variant)")
    ap.add_argument("--precision", default=None,
                    choices=["fp32", "bf16", "fp16"],
                    help="precision policy for the compute path (activation "
                         "+ cache dtypes; params keep their storage dtype)")
    ap.add_argument("--stages", default="2",
                    help="PNN partitioning for --mode pnn: N (uniform "
                         "split), 'auto' (repro_torch.plan searched "
                         "boundaries, K=2), or 'auto:K'")
    ap.add_argument("--dist-devices", type=int, default=None,
                    help="report the memory-balanced repro_torch.dist "
                         "placement of the PNN stages onto N devices")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    for flag, on in (("--seq-shard", args.seq_shard),
                     ("--rec-shard", args.rec_shard),
                     ("--moe-local", args.moe_local)):
        if on:
            raise SystemExit(mesh_refusal(flag))

    from repro_torch.plan import parse_stages
    pnn_strategy, pnn_stages = parse_stages(args.stages)

    archs = ARCH_NAMES if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape in shapes:
            variant = "plain"
            if args.mesh:
                variant += f"+mesh{args.mesh}"
            if args.accum:
                variant += f"+accum{args.accum}"
            if args.precision:
                variant += f"+{args.precision}"
            if args.mode == "pnn" and (pnn_strategy != "uniform"
                                       or pnn_stages != 2):
                variant += f"+stages{args.stages.strip().lower()}"
            if args.mode == "pnn" and args.dist_devices:
                variant += f"+dist{args.dist_devices}"
            is_multi = args.multi_pod or args.mode == "pipeline"
            key = f"{arch}|{shape}|{'multi' if is_multi else 'single'}" \
                f"|{args.mode}|{variant}"
            if key in results and results[key].get("status") in ("ok", "skipped") \
                    and not args.force:
                print(f"[cached] {key}")
                continue
            print(f"[dryrun] {key} ...", flush=True)
            try:
                rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                                 mode=args.mode, accum_override=args.accum,
                                 mesh_shape=tuple(int(x) for x in
                                                  args.mesh.split("x"))
                                 if args.mesh else None,
                                 precision=args.precision,
                                 pnn_stages=pnn_stages,
                                 pnn_strategy=pnn_strategy,
                                 dist_devices=args.dist_devices)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"  ERROR: {e}")
            results[key] = rec
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
            if rec.get("status") == "ok":
                if "analysis" in rec:
                    a = rec["analysis"]
                    print(f"  ok in {rec['elapsed_s']}s: "
                          f"compute={_ms(a['compute_s'])} "
                          f"memory={_ms(a['memory_s'])} "
                          f"collective={_ms(a['collective_s'])} "
                          f"dominant={a['dominant']}")
                else:
                    if "plan" in rec:
                        p = rec["plan"]
                        print(f"  plan[{p['strategy']}]: cuts {p['cuts']} "
                              f"pred-imbalance {p['predicted_imbalance']:.3f}")
                        for r in p["predicted_stages"]:
                            print(f"    stage{r['stage']} "
                                  f"units{r['units']}: "
                                  f"pred {r['bytes_total']/2**20:.0f}MiB "
                                  f"flops {r['flops']:.3g}")
                    for st in rec.get("pnn_stages", []):
                        a = st["analysis"]
                        print(f"  stage{st['stage']}: "
                              f"params/chip={st['stage_params_bytes_per_chip']/2**20:.0f}MiB "
                              f"coll={_ms(a['collective_s'])}")
                    if "placement" in rec:
                        pl = rec["placement"]
                        loads = "/".join(f"{b/2**20:.0f}MiB"
                                         for b in pl["loads_bytes"])
                        print(f"  placement[{pl['strategy']}]: "
                              f"stages->devices {pl['assignments']} "
                              f"loads {loads}")
            elif rec.get("status") == "skipped":
                print(f"  skipped: {rec['reason']}")
    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"done: {n_ok} ok, {n_err} errors, "
          f"{sum(1 for r in results.values() if r.get('status') == 'skipped')} skipped")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
