"""The port's analytic roofline and dry run (``repro_torch.launch.
{hlo_analysis,dryrun}``) against the reference's functions on the CPU.

* The three analytic functions (FLOPs, HBM bytes and peak bytes per chip)
  and ``_attn_layers`` at rtol 1e-12, for every applicable arch x input
  shape x n_chips in {1, 256, 512}, fed the same byte counts.
* ``dryrun_one``'s records, every applicable pair on the single pod in
  baseline mode and the pipeline and multi-pod records of a few: their keys
  are the reference's (``analysis`` adds ``no_artifact``, and the fields
  the reference reads off XLA's compiled artifact are null), and ``accum``,
  the bytes per chip, ``analysis``'s analytic terms,
  ``model_flops_per_chip``, ``useful_flops_ratio`` and
  ``sharding_decisions`` equal the reference's functions fed the same
  inputs.  The optimizer state's bytes differ only by the stacked vectors
  the reference's Adafactor factors (``tests/test_torch_sharding.py``).
  The PNN records (``pnn_stages``, ``plan``, the placement) for 2 and
  ``auto`` stages.  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at its
  module top, so it is never imported here: its ``model_flops`` and
  ``_predicted_plan`` are compiled from its source alone, and the
  paper-MLP record is held against its CLI run in a subprocess.
* The CLI, writing under ``tmp_path``, and the refused mesh flags.
"""
import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import plan as JPlan
from repro.configs import get as j_get
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.core import partition as JPart
from repro.launch import hlo_analysis as JH
from repro.launch import specs as JSpecs
from repro.launch import steps as JSteps
from repro.launch.sharding import Policy as JPolicy
from repro.models import model as JM
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch.configs import ARCH_NAMES, get
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import specs as TSpecs
from test_sharding import FakeMesh
from _torch_threads import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12
ANALYTIC = ("analytic_flops_per_chip", "analytic_hbm_bytes_per_chip",
            "analytic_peak_bytes_per_chip")
REF_ANALYSIS_KEYS = {"analytic_flops_per_chip", "analytic_hbm_bytes_per_chip",
                     "collectives", "memory_analysis", "hlo_raw", "compute_s",
                     "memory_s", "collective_s", "dominant"}
REF_KEYS = {"arch", "shape", "multi_pod", "mode", "seq_shard", "rec_shard",
            "status", "n_chips", "elapsed_s", "sharding_decisions",
            "model_flops_per_chip", "useful_flops_ratio",
            "params_bytes_per_chip", "analysis"}
KIND_KEYS = {"train": {"optimizer", "accum", "opt_bytes_per_chip"},
             "prefill": {"cache_bytes_per_chip"},
             "decode": {"cache_bytes_per_chip"}}


def _ref_dryrun():
    """``model_flops`` and ``_predicted_plan`` of ``repro/launch/dryrun.py``,
    compiled from its source without running its module top."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("model_flops", "_predicted_plan")]
    ns = {"time": time, "Dict": Dict, "Any": Any}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


REF = _ref_dryrun()


def _close(a, b):
    return abs(a - b) <= RTOL * max(abs(a), abs(b))


def _pairs():
    return [(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES
            if TSpecs.applicable(get(a), INPUT_SHAPES[s])[0]]


def _wrap(specs):
    class _Sh:
        def __init__(self, spec):
            self.spec = spec
    return jax.tree_util.tree_map(_Sh, specs,
                                  is_leaf=lambda x: isinstance(x, P))


def _jbytes(tree, specs, mesh):
    return JH.tree_bytes_per_chip(tree, _wrap(specs), mesh)


def _mesh_size(mesh, ent):
    n = 1
    for ax in (() if ent is None else ent if isinstance(ent, tuple)
               else (ent,)):
        n *= mesh.shape[ax]
    return n


def _adafactor_gap(jstruct, jspecs, mesh):
    """Per-chip bytes the port's Adafactor keeps beyond the reference's:
    a stacked (G, n) vector, G and n >= 32, is factored into (G,) and (n,)
    in the reference and is G full (n,) vectors in the port."""
    gap = 0
    flat = jax.tree_util.tree_leaves_with_path(jstruct)
    specs = jax.tree_util.tree_leaves(jspecs,
                                      is_leaf=lambda x: isinstance(x, P))
    for (path, leaf), sp in zip(flat, specs):
        if str(path[0].key) not in ("groups", "encoder") or \
                len(leaf.shape) != 2 or min(leaf.shape) < 32:
            continue
        lead, ent = tuple(sp) + (None,) * (2 - len(sp))
        g, n = leaf.shape
        dl, de = _mesh_size(mesh, lead), _mesh_size(mesh, ent)
        gap += 4 * (g * n // (dl * de) - g // dl - n // de)
    return gap


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_functions_match_reference(arch):
    """Every applicable shape of ``arch`` at 1, 256 and 512 chips, the
    byte inputs those of a 1-chip policy's record scaled by the chips."""
    jbase, tbase = j_get(arch), get(arch)
    assert H._attn_layers(tbase) == JH._attn_layers(jbase)
    for sname, shape in INPUT_SHAPES.items():
        if not TSpecs.applicable(tbase, shape)[0]:
            continue
        jshape = J_SHAPES[sname]
        jcfg = JSpecs.arch_for_shape(jbase, jshape)
        cfg = TSpecs.arch_for_shape(tbase, shape)
        for n in (1, 256, 512):
            kw = dict(params_bytes_per_chip=3_000_000_007 // n,
                      opt_bytes_per_chip=6_000_000_013 // n,
                      cache_bytes_per_chip=1_000_000_009 // n,
                      accum=JSteps.pick_accum(jcfg, jshape,
                                              JPolicy(jcfg, FakeMesh(n == 512))))
            got = H.analytic_flops_per_chip(cfg, shape, n)
            want = JH.analytic_flops_per_chip(jcfg, jshape, n)
            assert _close(got, want), (sname, n, got, want)
            for f in ANALYTIC[1:]:
                got = getattr(H, f)(cfg, shape, n, **kw)
                want = getattr(JH, f)(jcfg, jshape, n, **kw)
                assert _close(got, want), (f, sname, n, got, want)


def _reference_record(arch, sname, multi=False, mode="baseline"):
    """The reference's numbers for one pair, from its own functions on its
    own trees (``dryrun_one``'s steps without the lowering)."""
    jshape = J_SHAPES[sname]
    jcfg = JSpecs.arch_for_shape(j_get(arch), jshape)
    multi = multi or mode == "pipeline"
    mesh = FakeMesh(multi)
    pol = JPolicy(jcfg, mesh, pipeline=(mode == "pipeline"))
    struct = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    pspecs = pol.params_pspecs(struct)
    rec = {"n_chips": mesh.size,
           "params_bytes_per_chip": _jbytes(struct, pspecs, mesh)}
    if jshape.kind == "train":
        name = JSteps.pick_optimizer_name(jcfg)
        ost = jax.eval_shape(j_make_optimizer(name, 1e-3).init, struct)
        rec.update(optimizer=name, accum=JSteps.pick_accum(jcfg, jshape, pol),
                   opt_bytes_per_chip=_jbytes(
                       ost, pol.opt_state_pspecs(name, struct), mesh)
                   + (_adafactor_gap(struct, pspecs, mesh)
                      if name == "adafactor" else 0))
    else:
        cache = jax.eval_shape(lambda: JM.init_cache(
            jcfg, jshape.global_batch, jshape.seq_len))
        rec["cache_bytes_per_chip"] = _jbytes(
            cache, pol.cache_pspecs(cache, jshape.global_batch), mesh)
    rec["sharding_decisions"] = pol.explain()
    mf = REF["model_flops"](jcfg, jshape)
    rec["model_flops_per_chip"] = mf / mesh.size
    return jcfg, jshape, rec


def _assert_record(got, arch, sname, multi=False, mode="baseline"):
    jcfg, jshape, want = _reference_record(arch, sname, multi, mode)
    assert got["status"] == "ok"
    kind = jshape.kind
    assert set(got) == REF_KEYS | KIND_KEYS[kind], (arch, sname)
    a = got["analysis"]
    assert set(a) == REF_ANALYSIS_KEYS | {"no_artifact"}
    assert a["collectives"] is a["memory_analysis"] is a["hlo_raw"] \
        is a["collective_s"] is None
    for k, v in want.items():
        assert got[k] == v, (arch, sname, k, got[k], v)
    n = want["n_chips"]
    kw = dict(params_bytes_per_chip=got["params_bytes_per_chip"],
              opt_bytes_per_chip=got.get("opt_bytes_per_chip", 0),
              cache_bytes_per_chip=got.get("cache_bytes_per_chip", 0),
              accum=got.get("accum", 1))
    flops = JH.analytic_flops_per_chip(jcfg, jshape, n)
    hbm = JH.analytic_hbm_bytes_per_chip(jcfg, jshape, n, **kw)
    assert _close(a["analytic_flops_per_chip"], flops)
    assert _close(a["analytic_hbm_bytes_per_chip"], hbm)
    assert _close(a["compute_s"], flops / D.PEAK_FLOPS_BF16)
    assert _close(a["memory_s"], hbm / D.HBM_BW)
    assert a["dominant"] == ("compute_s" if a["compute_s"] >= a["memory_s"]
                             else "memory_s")
    assert _close(got["useful_flops_ratio"],
                  want["model_flops_per_chip"] / flops)
    assert got["mode"] == mode and got["multi_pod"] == (multi or
                                                       mode == "pipeline")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_baseline_records_match_reference(arch):
    """Every applicable shape of ``arch`` on the single pod."""
    for a, sname in _pairs():
        if a == arch:
            _assert_record(D.dryrun_one(arch, sname), arch, sname)
    if arch == "whisper-tiny":
        rec = D.dryrun_one(arch, "long_500k")
        assert rec["status"] == "skipped" and "enc-dec" in rec["reason"]


@pytest.mark.parametrize("arch,sname,multi,mode", [
    ("mistral-large-123b", "train_4k", True, "pipeline"),
    ("jamba-1.5-large-398b", "train_4k", False, "pipeline"),
    ("grok-1-314b", "decode_32k", True, "baseline"),
    ("qwen2-1.5b", "prefill_32k", True, "baseline")])
def test_pipeline_and_multi_pod_records_match_reference(arch, sname, multi,
                                                        mode):
    _assert_record(D.dryrun_one(arch, sname, multi_pod=multi, mode=mode),
                   arch, sname, multi, mode)


@pytest.mark.parametrize("stages", ["2", "auto"])
def test_pnn_records_match_reference(stages):
    """qwen2-1.5b x train_4k in PNN mode: every stage's bytes per chip and
    analytic terms, the plan and its predictions, and the memory-balanced
    placement onto one device."""
    strategy, n = JPlan.parse_stages(stages)
    got = D.dryrun_one("qwen2-1.5b", "train_4k", mode="pnn", pnn_stages=n,
                       pnn_strategy=strategy, dist_devices=1)
    jcfg = j_get("qwen2-1.5b")
    jshape = J_SHAPES["train_4k"]
    mesh = FakeMesh(False)
    pol = JPolicy(jcfg, mesh)
    name = JSteps.pick_optimizer_name(jcfg)
    plan = JPart.make_plan(jcfg, n, strategy=strategy,
                           **({"optimizer": name} if strategy == "auto"
                              else {}))
    assert got["plan"] == json.loads(json.dumps(
        REF["_predicted_plan"](jcfg, plan, strategy, name)))
    assert got["optimizer"] == name and got["n_stages"] == plan.n_stages
    struct = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    loads = 0
    for k, st in enumerate(got["pnn_stages"]):
        sp = jax.eval_shape(
            lambda ps: JPart.slice_stage_params(jcfg, plan, ps, k), struct)
        so = jax.eval_shape(j_make_optimizer(name, 1e-3).init, sp)
        spb = _jbytes(sp, pol.params_pspecs(sp), mesh)
        sob = _jbytes(so, pol.opt_state_pspecs(name, sp), mesh)
        assert (st["stage"], st["stage_params_bytes_per_chip"],
                st["stage_opt_bytes_per_chip"]) == (k, spb, sob)
        hbm = JH.analytic_hbm_bytes_per_chip(
            jcfg, jshape, 256, params_bytes_per_chip=spb,
            opt_bytes_per_chip=sob)
        assert _close(st["analysis"]["analytic_hbm_bytes_per_chip"], hbm)
        loads += spb + sob
    assert got["placement"] == {"strategy": "memory",
                                "assignments": [0] * plan.n_stages,
                                "loads_bytes": [loads]}
    assert got["sharding_decisions"] == pol.explain()
    assert "accum" not in got and got["n_chips"] == 256


@pytest.mark.parametrize("stages", ["2", "auto"])
def test_paper_mlp_record_matches_reference_cli(tmp_path, stages):
    """The paper MLP's PNN plan record against the reference's CLI (a
    subprocess: its module top sets XLA_FLAGS)."""
    out = tmp_path / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch",
                    "paper_mlp", "--shape", "train_4k", "--mode", "pnn",
                    "--stages", stages, "--out", str(out)],
                   check=True, capture_output=True, env=env, cwd=tmp_path)
    (want,) = json.loads(out.read_text()).values()
    strategy, n = JPlan.parse_stages(stages)
    got = json.loads(json.dumps(D.dryrun_one(
        "paper_mlp", "train_4k", mode="pnn", pnn_stages=n,
        pnn_strategy=strategy)))
    for rec in (want, got):
        rec.pop("elapsed_s")
    assert got == want
    assert D.dryrun_one("paper_mlp", "decode_32k")["status"] == "skipped"


def test_cli_writes_records_and_refuses_mesh_flags(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a card-less machine: the
    records, the cache on a second run, and the mesh flags refused."""
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "xlstm-125m", "--out", str(out)]
    run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert "done: 4 ok, 0 errors, 0 skipped" in run.stdout
    recs = json.loads(out.read_text())
    assert sorted(recs) == sorted(f"xlstm-125m|{s}|single|baseline|plain"
                                  for s in INPUT_SHAPES)
    for key, rec in recs.items():
        _assert_record(rec, "xlstm-125m", key.split("|")[1])
    again = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=tmp_path)
    assert again.stdout.count("[cached]") == 4
    for flag in ("--seq-shard", "--rec-shard", "--moe-local"):
        bad = subprocess.run(cmd + [flag], capture_output=True, text=True,
                             env=env, cwd=tmp_path)
        assert bad.returncode != 0 and "step 5" in bad.stderr
        with pytest.raises(ValueError, match="more than one card"):
            D.dryrun_one("xlstm-125m", "train_4k",
                         **{flag[2:].replace("-", "_"): True})
