"""``repro_torch.verify``'s oracle registry against ``repro.verify``'s: the
same 16 names, tags, ``arch_aware`` flags and policies; the kernel
inventory (``FAMILIES``) covered; the ``Bitwise`` and ``TokensEqual`` tiers
(the reference's unit tests, and torch leaves); ``run_oracle``, the
report and the sweep CLI; and every oracle whose port run on the CPU costs
a few seconds, run at ``tiny`` on the CPU, where each must pass (the
arch-aware ones for qwen2-1.5b and for the Jamba smoke config).

Two oracles are not run here; both run on the card in ``chip_smoke.py``'s
``verify`` phase (CPU seconds of one run at ``tiny``):

* ``plan/auto_vs_hand`` — 13.2 s.  At ``tiny`` it misses its 0.05 budget
  on the CPU: the hand cut reaches 0.682 after tiny's 80 right-stage
  epochs, the searched cut 0.994 (gap 0.312), the port's known tiny gap
  (the paper gate's ``tiny`` misses by 0.3124 on the card: ``PERF.md``,
  ROADMAP C).  The card gates it at ``full`` (160 epochs).
* ``paper/emnist_parity`` — ~20 s (the paper gate at ``tiny``, which
  misses its budget in the port, gap 0.3124 on the card; the card's
  ``train`` phase runs both presets, ``full`` passes).
"""
import json

import numpy as np
import pytest
import torch

import repro.verify as JV
from repro.kernels import FAMILIES as J_FAMILIES
from repro_torch.kernels import FAMILIES
from repro_torch.launch import verify as launch_verify
from repro_torch.verify import (AccuracyGap, Allclose, Bitwise, Context,
                                TokensEqual, all_oracles, build_report, get,
                                run_oracle, write_report)
from repro_torch.verify.oracle import Oracle

ORACLE_NAMES = [o.name for o in all_oracles()]
NOT_ON_CPU = ("plan/auto_vs_hand", "paper/emnist_parity")
CPU_ORACLES = [n for n in ORACLE_NAMES if n not in NOT_ON_CPU]
JAMBA = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small ops, which several
    threads a process slow down many times over when the suite runs its
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(o, preset):
    pol = o.resolve_policy(Context(preset=preset, device="cpu")) \
        if callable(o.policy) else o.policy
    return type(pol).__name__, getattr(pol, "__dict__", {})


def test_registry_matches_reference():
    want = {o.name: o for o in JV.all_oracles()}
    assert ORACLE_NAMES == sorted(want) and len(ORACLE_NAMES) == 16
    for o in all_oracles():
        j = want[o.name]
        assert (o.contract, o.tags, o.arch_aware) == \
            (j.contract, j.tags, j.arch_aware), o.name
        assert callable(o.policy) == callable(j.policy), o.name
        for preset in ("tiny", "full"):
            jp = j.resolve_policy(JV.Context(preset=preset)) \
                if callable(j.policy) else j.policy
            assert _policy(o, preset) == (type(jp).__name__,
                                          getattr(jp, "__dict__", {})), \
                (o.name, preset)
    assert [o.name for o in all_oracles(tags=["serve"])] == \
        [o.name for o in JV.all_oracles(tags=["serve"])]
    with pytest.raises(KeyError, match="no oracle"):
        get("kernel/warp_drive")


def test_every_kernel_family_has_an_oracle():
    assert FAMILIES == J_FAMILIES
    kernel_oracles = {n.split("/", 1)[1] for n in ORACLE_NAMES
                      if n.startswith("kernel/")}
    for family, entry_points in FAMILIES.items():
        for entry in entry_points:
            assert entry in kernel_oracles, f"{family}/{entry} has no oracle"


@pytest.mark.parametrize("name", CPU_ORACLES)
def test_oracle_conformance(name, tmp_path):
    res = run_oracle(get(name), Context(preset="tiny", workdir=str(tmp_path),
                                        device="cpu"))
    detail = res.error or (res.verdict.detail if res.verdict else "")
    assert res.ok, f"{name} violated its contract: {detail}"


@pytest.mark.parametrize("name", [o.name for o in all_oracles()
                                  if o.arch_aware])
def test_arch_aware_oracle_on_jamba(name, tmp_path):
    res = run_oracle(get(name), Context(preset="tiny", arch=JAMBA,
                                        workdir=str(tmp_path), device="cpu"))
    assert res.ok, res.error or res.verdict.detail


def test_scenarios_match_reference(monkeypatch):
    from dataclasses import asdict

    from repro.verify import scenarios as JS
    from repro_torch.verify import scenarios as TS
    # the reference's params are not compared (threefry): skip drawing them
    monkeypatch.setattr(JS.M, "init_params", lambda cfg, key: None)
    kw = dict(n_stages=2, epochs=(), sizes=(784, 32, 16, 16, 47),
              n_train=470, n_test=94, batch_size=470, lr=0.02,
              precision="bf16", baseline_epochs=3)
    (jc, jd, js), (tc, td, ts) = JS.tiny_mlp(**kw), TS.tiny_mlp(**kw)
    assert (tc.sizes, tc.cut) == (jc.sizes, jc.cut)
    assert asdict(ts) == asdict(js)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(a, b)
    jcfg, jplan, jbatch, jspec, _ = JS.tiny_lm(steps=2, accum=2)
    tcfg, tplan, tbatch, tspec, params = TS.tiny_lm(
        steps=2, accum=2, batch_fn=lambda i: {
            k: np.asarray(v) for k, v in jbatch(i).items()})
    assert tplan.bounds == jplan.bounds and asdict(tspec) == asdict(jspec)
    np.testing.assert_array_equal(tbatch(3)["tokens"],
                                  np.asarray(jbatch(3)["tokens"]))
    own = TS.tiny_lm()[2](3)["tokens"]
    assert own.shape == (2, 32) and own.max() < tcfg.vocab_size
    assert params["tok_embed"].device == torch.device("cpu")
    cfg = TS.serve_cfg(JAMBA, window=8)
    assert (cfg.dtype, cfg.sliding_window) == ("float32", 8)
    for a, b in zip(JS.serve_requests(JS.serve_cfg()),
                    TS.serve_requests(TS.serve_cfg())):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.id, a.gen.max_new_tokens) == (b.id, b.gen.max_new_tokens)


def test_context_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Context()
    assert Context(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown preset"):
        Context(preset="huge", device="cpu")


def test_run_oracle_captures_exceptions():
    def boom(ctx):
        raise RuntimeError("injected failure")
    o = Oracle(name="x/boom", contract="always fails", run=boom,
               policy=Bitwise())
    res = run_oracle(o, Context(device="cpu"))
    assert not res.ok and "injected failure" in res.error
    assert "error" in res.row()


def test_report_keys_match_reference(tmp_path):
    res = run_oracle(get("kernel/sil_mse"), Context(device="cpu"))
    report = build_report([res], preset="tiny", arch="qwen2-1.5b")
    jres = JV.OracleResult("kernel/sil_mse", True, 0.5,
                           verdict=JV.Verdict(True, "allclose"))
    want = JV.build_report([jres], preset="tiny", arch="qwen2-1.5b")
    assert sorted(report) == sorted(want)
    assert report["schema"] == want["schema"] == "repro.verify/1"
    assert sorted(report["oracles"][0]) == sorted(want["oracles"][0])
    assert report["env"]["torch"] == torch.__version__
    assert "force_ref" not in report["env"]
    path = str(tmp_path / "CONFORMANCE.json")
    write_report(path, [res], preset="tiny", arch="qwen2-1.5b",
                 extra={"note": "unit"})
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["oracles"] == report["oracles"]
    assert on_disk["note"] == "unit" and on_disk["n_passed"] == 1


def test_verify_cli_list_and_kernel_sweep(tmp_path, capsys):
    assert launch_verify.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(n in out for n in ORACLE_NAMES)
    assert "[arch-aware]" in out
    assert launch_verify.main(["--only", "no/such"]) == 2
    path = str(tmp_path / "CONFORMANCE_torch.json")
    assert launch_verify.main(["--only", "kernel", "--device", "cpu",
                               "--json", path]) == 0
    rep = json.load(open(path))
    assert rep["n_oracles"] == 4 and rep["n_failed"] == 0
    assert rep["device"] == "cpu"
    assert launch_verify.DEFAULT_JSON == "results/CONFORMANCE_torch.json"


# -- the comparison policies --------------------------------------------------

def test_bitwise_catches_single_bit():
    a = {"w": np.arange(8, dtype=np.float32)}
    assert Bitwise().compare(a, {"w": a["w"].copy()}).ok
    b = a["w"].copy()
    b[3] = np.nextafter(b[3], np.inf)
    v = Bitwise().compare(a, {"w": b})
    assert not v.ok and v.metrics["n_diff"] == 1
    t = torch.arange(8, dtype=torch.bfloat16)
    assert Bitwise().compare([t], [t.clone()]).ok
    u = t.clone()
    u[5] += 1
    assert Bitwise().compare([t], [u]).metrics["n_diff"] == 1
    # dtype and shape count, values alone do not
    assert not Bitwise().compare([t], [t.float()]).ok
    assert not Bitwise().compare([t], [t[:4]]).ok
    assert not Bitwise().compare([t], [t, t]).ok
    nan = torch.tensor([float("nan"), 1.0])
    assert Bitwise().compare([nan], [nan.clone()]).ok


def test_allclose_and_accuracy_gap_tiers():
    a32 = np.ones((4,), np.float32)
    v = Allclose().compare({"x": a32}, {"x": a32 + 1e-3})
    assert not v.ok and v.metrics["rtol"] == 1e-5
    a16 = torch.ones((4,), dtype=torch.bfloat16)
    assert Allclose().compare({"x": a16}, {"x": a16 + 1e-3}).ok
    p = AccuracyGap(budget=0.02, floor=0.5)
    assert p.compare(0.90, 0.89).ok
    assert not p.compare(0.90, 0.85).ok
    assert not p.compare(0.10, 0.10).ok


def test_tokens_equal():
    assert TokensEqual().compare([(1, 2, 3)], [(1, 2, 3)]).ok
    assert not TokensEqual().compare([(1, 2, 3)], [(1, 2, 4)]).ok
    assert not TokensEqual().compare([(1, 2)], [(1, 2), (3,)]).ok
    v = TokensEqual().compare([(1, 2), [3]], [[1, 2], (3,)])
    assert v.ok and v.metrics == {"n_sequences": 2, "n_tokens": 3}
