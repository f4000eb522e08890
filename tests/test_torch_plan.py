"""The port's auto-partitioner (``repro_torch.plan``: the cost tables and
the bottleneck searcher) and the entry points that take ``"auto"`` against
``repro.plan`` on the CPU.

Cost tables are held field by field: bytes and element counts exactly,
FLOPs to a relative 1e-12 (the same float formulas over the same integer
counts; the LM table reads the port's tree on the meta device where the
reference reads ``jax.eval_shape``).  The searcher is pure Python over
those tables, so its bounds, bottlenecks, frontiers and reports are held
equal, as JSON where the reference writes JSON.
"""
import json

import numpy as np
import pytest
import torch

from repro import plan as JPlan
from repro.configs import get as jget
from repro.core import partition as JP
from repro.launch import plan as jlaunch_plan
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.train.backends import balanced_bounds as jbalanced_bounds
from repro_torch import plan as TPlan
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get as tget
from repro_torch.core import partition as TP
from repro_torch.launch import plan as launch_plan
from repro_torch.launch import train as launch_train
from repro_torch.models.mlp import MLPConfig
from repro_torch.train import recipes
from repro_torch.train.backends import balanced_bounds

UNIT_FIELDS = ("unit_param_bytes", "unit_param_elems", "unit_act_bytes",
               "unit_boundary_bytes")
SCALAR_FIELDS = ("kind", "n_units", "optimizer", "head_param_bytes",
                 "head_param_elems", "tail_param_bytes", "tail_param_elems",
                 "tail_frozen_bytes")
FLOP_FIELDS = ("head_flops", "tail_flops")


def _same_table(got, want):
    for f in SCALAR_FIELDS + UNIT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in FLOP_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, err_msg=f)
    np.testing.assert_allclose(got.unit_flops, want.unit_flops, rtol=1e-12)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_costs_match_reference(arch, smoke):
    """Every arch of the port, at its full size (on the meta device: no
    weight is made) at the default B8 S512 with AdamW, and at its smoke
    size at another workload with SGD-momentum (through ``costs_for``,
    which drops the MLP's keywords)."""
    jcfg, tcfg = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    kw = {"batch": 2, "seq": 96, "optimizer": "sgdm"} if smoke else {}
    _same_table(TPlan.costs_for(tcfg, batch_size=9, **kw),
                JPlan.lm_costs(jcfg, **kw))


def test_llava_cut_costs_as_measured():
    """The 4-layer cut of llava-next-34b that the card trains: the even
    split is the searched one, at 16.43 / 15.86 GB a stage (bf16 params
    and two fp32 AdamW slots, the default B8 S512); the vision head holds
    ``tok_embed`` and ``img_proj``."""
    cfg = tget("llava-next-34b").replace(n_layers=4)
    table = TPlan.lm_costs(cfg)
    assert table.head_param_elems == 64000 * 7168 + 7168 * 7168
    assert TPlan.auto_plan(cfg, 2).bounds == ((0, 2), (2, 4))
    rows = [c.bytes_total for c in table.stage_costs(((0, 2), (2, 4)))]
    assert [round(b / 1e9, 2) for b in rows] == [16.43, 15.86]
    for n in (8, 60):
        c = tget("llava-next-34b").replace(n_layers=n)
        assert TPlan.auto_plan(c, 2).bounds == ((0, n // 2), (n // 2, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_costs_match_reference(dtype):
    for cfg, jcfg in ((MLPConfig(), JMLPConfig()),
                      (MLPConfig(sizes=(784, 32, 16, 16, 47), cut=2),
                       JMLPConfig(sizes=(784, 32, 16, 16, 47), cut=2))):
        for kw in ({}, {"batch_size": 64, "optimizer": "adamw"}):
            _same_table(TPlan.mlp_costs(cfg, compute_dtype=dtype, **kw),
                        JPlan.mlp_costs(jcfg, compute_dtype=dtype, **kw))


def _random_tables(seed):
    """A seeded random table with head and tail overheads, in both
    packages (the same integers and floats)."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(3, 11))
    kw = dict(
        kind="lm", n_units=n, optimizer=["sgd", "sgdm", "adamw"][seed % 3],
        unit_param_bytes=tuple(int(x) for x in rng.randint(1, 1000, n)),
        unit_param_elems=tuple(int(x) for x in rng.randint(1, 500, n)),
        unit_act_bytes=tuple(int(x) for x in rng.randint(0, 300, n)),
        unit_flops=tuple(float(x) for x in rng.rand(n) * 1e6),
        unit_boundary_bytes=tuple(int(x) for x in rng.randint(0, 200, n)),
        head_param_bytes=int(rng.randint(0, 3000)),
        head_param_elems=int(rng.randint(0, 1000)),
        head_flops=float(rng.rand() * 1e6),
        tail_param_bytes=int(rng.randint(0, 3000)),
        tail_param_elems=int(rng.randint(0, 1000)),
        tail_frozen_bytes=int(rng.randint(0, 2000)),
        tail_flops=float(rng.rand() * 1e6))
    return TPlan.ModelCosts(**kw), JPlan.ModelCosts(**kw)


@pytest.mark.parametrize("seed", range(6))
def test_searcher_matches_reference_on_random_tables(seed):
    """``solve`` (both objectives, every K), ``frontier``,
    ``brute_force_bounds`` and ``search_report`` on seeded random tables;
    the searched bottleneck is the exhaustive one."""
    t, j = _random_tables(seed)
    for k in range(1, min(t.n_units, 4) + 1):
        for obj in ("bytes", "flops"):
            got = TPlan.solve(t, k, objective=obj)
            assert got == JPlan.solve(j, k, objective=obj)
            bt, bb = TPlan.brute_force_bounds(t, k, objective=obj)
            assert (bt, bb) == JPlan.brute_force_bounds(j, k, objective=obj)
            cost = TPlan.search.stage_objective(t, obj)
            assert max(cost(lo, hi, i, k) for i, (lo, hi)
                       in enumerate(got)) == pytest.approx(bt, rel=1e-9)
            assert TPlan.frontier(t, k, got, objective=obj) == \
                JPlan.frontier(j, k, got, objective=obj)
        assert json.dumps(TPlan.search_report(t, k)) == \
            json.dumps(JPlan.search_report(j, k))
    assert TPlan.uniform_bounds(7, 3) == JPlan.uniform_bounds(7, 3)
    assert TPlan.predicted_imbalance(t.stage_costs(((0, t.n_units),))) == 1.0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-tiny",
                                  "xlstm-125m", "llava-next-34b"])
def test_auto_plan_and_report_match_reference(arch):
    """``auto_plan``'s bounds and ``plan_report`` as JSON, full size, 2 and
    3 stages and the flops objective; ``make_plan("auto")`` and
    ``resolve_plan("auto" / "auto:K")`` route there in both packages."""
    jcfg, tcfg = jget(arch), tget(arch)
    want = {k: JP.make_plan(jcfg, k, strategy="auto").bounds for k in (2, 3)}
    assert TPlan.auto_plan(tcfg, 3).bounds == want[3]
    assert TP.make_plan(tcfg, 2, strategy="auto").bounds == want[2]
    assert recipes.resolve_plan(tcfg, "auto:3").bounds == want[3]
    assert recipes.resolve_plan(tcfg, "auto").bounds == want[2]
    assert recipes.resolve_plan(tcfg, 2).bounds == \
        TP.make_plan(tcfg, 2).bounds
    assert json.dumps(TPlan.plan_report(tcfg, 3)) == \
        json.dumps(JPlan.plan_report(jcfg, 3))
    assert json.dumps(TPlan.plan_report(tcfg, 2, objective="flops",
                                        batch=2, seq=64)) == \
        json.dumps(JPlan.plan_report(jcfg, 2, objective="flops", batch=2,
                                     seq=64))


def test_mlp_bounds_match_reference():
    """``auto_mlp_bounds`` and ``balanced_bounds(costs=...)`` through all
    three routes (``"auto"``, a table, a scalar sequence); a bad string
    raises in both."""
    cfg, jcfg = MLPConfig(), JMLPConfig()
    for k in (2, 3, 4):
        assert TPlan.auto_mlp_bounds(cfg, k) == JPlan.auto_mlp_bounds(jcfg, k)
        assert balanced_bounds(cfg, k, costs="auto") == \
            jbalanced_bounds(jcfg, k, costs="auto")
        assert balanced_bounds(cfg, k, costs=TPlan.mlp_costs(cfg)) == \
            jbalanced_bounds(jcfg, k, costs=JPlan.mlp_costs(jcfg))
        seq = [5.0, 1.0, 1.0, 3.0, 2.0]
        assert balanced_bounds(cfg, k, costs=seq) == \
            jbalanced_bounds(jcfg, k, costs=seq)
        assert balanced_bounds(cfg, k) == jbalanced_bounds(jcfg, k)
    json_t = json.dumps(TPlan.plan_report(cfg, 2))
    assert json_t == json.dumps(JPlan.plan_report(jcfg, 2))
    with pytest.raises(ValueError, match="bad costs"):
        balanced_bounds(cfg, 2, costs="uniform")


@pytest.mark.parametrize("text,want", [
    ("3", ("uniform", 3)), (3, ("uniform", 3)), ("auto", ("auto", 2)),
    ("auto:4", ("auto", 4)), (" AUTO:2 ", ("auto", 2)), ("auto:x", None),
    ("auto4", None), ("two", None), ("", None)])
def test_parse_stages_matches_reference(text, want):
    if want is None:
        for parse in (TPlan.parse_stages, JPlan.parse_stages):
            with pytest.raises(ValueError, match="bad --stages"):
                parse(text)
        return
    assert TPlan.parse_stages(text) == JPlan.parse_stages(text) == want
    assert TPlan.parse_stages("auto", default_k=5) == ("auto", 5)


def test_train_cli_takes_stages_auto(capsys):
    """``--stages auto:K`` on the paper's MLP prints and trains on the
    searched bounds, the reference's (uneven here: the first layer holds
    most of the bytes); the LM case is held in
    ``tests/test_torch_lm_train.py`` and ``tests/test_torch_parallel.py``."""
    launch_train.main(["--arch", "paper_mlp", "--smoke", "--mode", "pnn",
                       "--stages", "auto:3", "--steps", "1", "--device",
                       "cpu"])
    want = JPlan.auto_mlp_bounds(JMLPConfig(sizes=(784, 32, 16, 16, 47),
                                            cut=2), 3, batch_size=1410)
    assert want != JPlan.uniform_bounds(4, 3)
    assert f"plan[auto]: 3 stages, bounds {want}" in capsys.readouterr().out


def test_plan_cli_report_matches_reference(tmp_path):
    """The plan CLI's report, schema 1, for one arch and the paper's MLP:
    every record the reference's CLI writes, as JSON (the ``tool`` names
    the package)."""
    for arch, k in (("qwen2-1.5b", "4"), ("paper_mlp", "auto:3"),
                    ("whisper-tiny", "9")):
        out, jout = tmp_path / f"{arch}.json", tmp_path / f"{arch}-ref.json"
        assert launch_plan.main(["--arch", arch, "--stages", k, "--out",
                                 str(out)]) == 0
        assert jlaunch_plan.main(["--arch", arch, "--stages", k, "--out",
                                  str(jout)]) == 0
        got, want = json.loads(out.read_text()), json.loads(jout.read_text())
        assert got.pop("tool") == "repro_torch.launch.plan"
        want.pop("tool")
        assert got == want and got["schema"] == 1
    assert got["archs"]["whisper-tiny"]["n_stages_requested"] == 9


@pytest.mark.parametrize("arch,code", [("qwen2-1.5b", 0),
                                       ("llava-next-34b", 1)])
def test_plan_cli_assert_exit_code(arch, code, tmp_path, capsys):
    """``--assert-nonuniform`` exits 1 where the searched cut is the
    uniform one (llava's 60 identical groups), 0 where the searcher moved
    it (qwen2's tied table), as the reference's CLI does."""
    argv = ["--arch", arch, "--stages", "2", "--assert-nonuniform",
            "--out", str(tmp_path / "p.json")]
    assert launch_plan.main(argv) == code
    assert jlaunch_plan.main(argv) == code
    if code:
        assert "ASSERT FAILED llava-next-34b: searched cut degenerated" in \
            capsys.readouterr().err


def test_estimate_bytes_read_meta_tensors():
    """The byte model reads shapes and dtypes alone: a meta tree costs
    what the same tree in memory costs."""
    t = {"w": torch.empty(3, 5, dtype=torch.bfloat16, device="meta"),
         "tied_unembed": torch.empty(4, dtype=torch.float32, device="meta")}
    assert TPlan.estimate_stage_bytes(t, "adamw") == \
        3 * 5 * 2 + 4 * 4 + 2 * 3 * 5 * 4
