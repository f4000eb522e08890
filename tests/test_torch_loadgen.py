"""The port's open-loop load generator and metrics CLI
(``repro_torch.launch.{loadgen,metrics}``) against the reference's
``repro.launch.{loadgen,metrics}`` on the CPU.

The workload (tokens, arrivals, ``n``, ``rate``) is numpy in both packages
and must match bit for bit; the report checks, the dump and the summary
must give the same errors and strings on the same reports.  A loadgen run
is open loop on the wall clock, so only its counts are deterministic: the
port's ``run_loadgen("tiny", n=4, rate=50.0)`` serves the reference's
seed-0 params (carried across with ``repro_torch.convert``) and is held to
the counts the reference's run gives on those inputs.  The reference's run
takes ~16 s on a CPU (one compile a shape), so it is not repeated here:
the counts are the ones its own test asserts
(``tests/test_obs.py::test_loadgen_tiny_report_and_metrics_cli``) and the
event totals and token count it reported for the same call.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.launch import loadgen as JL
from repro.launch import metrics as JMet
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy
from repro_torch.launch import loadgen as TL
from repro_torch.launch import metrics as TMet
from _torch_threads import _one_thread  # noqa: F401

# the reference's run_loadgen("tiny", seed=0, n=4, rate=50.0) on its seed-0
# params: one oversized request shed, three admitted and retired, 12 tokens
REF_TINY = {"ttft_count": 3, "rejected_cache": 1, "shed_rate": 0.25,
            "completed": 3, "n_tokens": 12,
            "by_kind": {"generate_begin": 1, "reject": 1, "admit": 3,
                        "retire": 3, "generate_end": 1}}

HIST = {"name": "serve_ttft_ms", "kind": "histogram", "labels": {},
        "count": 3, "mean": 12.5, "p50": 10.0, "p90": 25.0, "p99": 25.0,
        "max": 21.0}
SLO = {"ttft_ms": {"count": 3, "p50": 10.0, "p99": 25.0},
       "ttft_stream_ms": {"count": 3, "p50": 10.0, "p99": 26.5},
       "tokens_per_s": 123.4, "n_tokens": 12, "wall_s": 0.1,
       "queue_depth": {"count": 4, "p50": 1.0, "p99": 2.0},
       "slots_busy": {"count": 4, "p50": 1.0, "p99": 2.0},
       "peak_slots_busy": 2.0, "cache_tokens": 64.0,
       "shed": {"rate": 0.25, "rejected_cache": 1, "rejected_queue": 0,
                "rejected_deadline": 0},
       "completed": 3}
GOOD = {"schema": "repro.obs/1", "kind": "loadgen", "preset": "tiny",
        "workload": {"n_requests": 4, "rate_rps": 50.0, "paged": False},
        "slo": SLO,
        "metrics": [
            {"name": "serve_rejected_total", "kind": "counter",
             "labels": {"reason": "cache"}, "value": 1},
            {"name": "serve_peak_slots_busy", "kind": "gauge",
             "labels": {}, "value": 2.0},
            HIST]}
COMPARED = dict(GOOD, workload=dict(GOOD["workload"], paged=True),
                comparison={"paged_peak_slots_busy": 5.0,
                            "contiguous_peak_slots_busy": 2.0,
                            "baseline_slots": 2, "paged_p99_ttft_ms": 30.0,
                            "contiguous_p99_ttft_ms": 40.0, "ok": True})
PLAIN = {"schema": "repro.obs/1", "metrics": GOOD["metrics"]}
# tests/test_obs.py::test_metrics_cli_check_fails_on_violations's report
BAD = {"schema": "nope", "metrics": [
    {"name": "h", "kind": "histogram", "count": 5,
     "p50": None, "p90": None, "p99": None},
    {"name": "c", "kind": "counter"},
]}
BAD_SLO = dict(GOOD, slo={"ttft_ms": {"count": 0}, "tokens_per_s": 0,
                          "shed": {"rate": 0.0}},
               metrics=[{"kind": "counter"}, dict(HIST, p90=None),
                        {"name": "x", "kind": "histogram", "count": 1}])
REPORTS = {"good": GOOD, "compared": COMPARED, "plain": PLAIN, "bad": BAD,
           "bad_slo": BAD_SLO, "empty": {}}


@pytest.fixture(scope="module")
def ref_params():
    """The reference's run_loadgen params (tiny preset's smoke qwen2 in
    fp32, PRNGKey(0)) as a port tree on the CPU."""
    jcfg = j_get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")


@pytest.mark.parametrize("preset,n,rate", [
    ("tiny", None, None), ("full", None, None), ("paged", None, None),
    ("full", 7, 3.5)], ids=["tiny", "full", "paged", "override"])
def test_build_workload_matches_reference(preset, n, rate):
    assert TL.PRESETS == JL.PRESETS
    p = TL.PRESETS[preset]
    jcfg, tcfg = j_get(p["arch"], smoke=True), get(p["arch"], smoke=True)
    jreqs, jarr, jn, jrate = JL.build_workload(jcfg, p, 3, n=n, rate=rate)
    treqs, tarr, tn, trate = TL.build_workload(tcfg, p, 3, n=n, rate=rate)
    assert (tn, trate, tarr) == (jn, jrate, jarr)
    assert len(treqs) == len(jreqs) == tn
    for j, t in zip(jreqs, treqs):
        assert t.id == j.id
        assert t.gen.max_new_tokens == j.gen.max_new_tokens
        assert t.tokens.dtype == j.tokens.dtype
        np.testing.assert_array_equal(t.tokens, j.tokens)


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_report_checks_match_reference(name):
    """validate_report's errors, dump and summary, word for word."""
    report = REPORTS[name]
    assert TMet.validate_report(report) == JMet.validate_report(report)
    assert (TMet.validate_report(report) == []) == \
        (name in ("good", "compared", "plain"))
    if name in ("good", "compared", "plain"):
        assert TMet.dump(report) == JMet.dump(report)
        assert TMet.summary(report) == JMet.summary(report)


@pytest.mark.parametrize("name", ["good", "bad", "plain"])
def test_metrics_main_matches_reference(name, tmp_path, capsys):
    """``--check``, ``--dump`` and the summary: exit codes and output."""
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(REPORTS[name], f)
    for flags in (["--check"], ["--dump"], []):
        if name == "bad" and flags != ["--check"]:
            continue
        want = JMet.main(flags + [path]), capsys.readouterr().out
        got = TMet.main(flags + [path]), capsys.readouterr().out
        assert got == want, flags
    assert TMet.main(["--check", path]) == (1 if name == "bad" else 0)


def test_run_loadgen_tiny_counts_match_reference(ref_params, tmp_path):
    report = TL.run_loadgen("tiny", seed=0, n=4, rate=50.0, device="cpu",
                            params=ref_params,
                            trace_path=str(tmp_path / "trace.json"))
    assert TMet.validate_report(report) == []
    slo = report["slo"]
    assert slo["ttft_ms"]["count"] == REF_TINY["ttft_count"]
    assert slo["ttft_ms"]["p50"] is not None
    assert slo["ttft_ms"]["p99"] is not None
    assert slo["ttft_stream_ms"]["count"] == REF_TINY["ttft_count"]
    assert slo["tokens_per_s"] > 0
    assert slo["shed"]["rejected_cache"] == REF_TINY["rejected_cache"]
    assert slo["shed"]["rate"] == pytest.approx(REF_TINY["shed_rate"])
    assert slo["completed"] == REF_TINY["completed"]
    assert slo["n_tokens"] == REF_TINY["n_tokens"]
    assert report["events"]["by_kind"] == REF_TINY["by_kind"]
    assert report["workload"]["block_size"] is None
    assert "tok/s" in TL.summarize(report)
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_run_compare_small(ref_params, tmp_path):
    """n=6 of the paged preset: both pools serve the same trace under the
    same budget (2 contiguous rows of 32 against 8 blocks of 8); the
    verdict's keys are the reference's.  Who wins at n=6 rides on the
    clock, so it is not asserted."""
    b9 = tmp_path / "BENCH_9_torch.json"
    b9.write_text(json.dumps({"slo": {"ttft_ms": {"p99": 1e9}}}))
    rep = TL.run_compare("paged", n=6, device="cpu", params=ref_params,
                         bench9_path=str(b9))
    assert TMet.validate_report(rep) == []
    cmp_ = rep["comparison"]
    assert sorted(cmp_) == sorted(
        ["baseline_slots", "paged_peak_slots_busy",
         "contiguous_peak_slots_busy", "concurrency_ok",
         "paged_p99_ttft_ms", "contiguous_p99_ttft_ms", "ttft_ok",
         "paged_completed", "contiguous_completed", "bench9_p99_ttft_ms",
         "ttft_ok_vs_bench9", "ok"])
    assert cmp_["baseline_slots"] == 2
    assert cmp_["paged_completed"] == cmp_["contiguous_completed"] == 5
    assert cmp_["ttft_ok_vs_bench9"]
    assert rep["workload"]["block_size"] == 8
    assert rep["baseline"]["workload"]["slots"] == 2
    assert rep["baseline"]["slo"]["shed"]["rejected_cache"] == 1
    assert "compare: paged peak=" in TL.summarize(rep)


def test_main_writes_only_under_tmp_path(tmp_path, monkeypatch, capsys):
    """The CLI's default report path is relative to the working directory
    and is the port's own (never the reference's results/BENCH_9.json)."""
    monkeypatch.chdir(tmp_path)
    assert TL.main(["--preset", "tiny", "--n", "3", "--rate", "50",
                    "--device", "cpu", "--trace", "t/trace.json"]) == 0
    assert sorted(str(p.relative_to(tmp_path))
                  for p in tmp_path.rglob("*") if p.is_file()) == \
        ["results/BENCH_9_torch.json", "t/trace.json"]
    out = capsys.readouterr().out
    assert "wrote results/BENCH_9_torch.json and t/trace.json" in out
    assert TMet.main(["--check", "results/BENCH_9_torch.json"]) == 0


def test_loadgen_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.main(["--preset", "tiny", "--n", "2"])
