"""``repro_torch.resilience`` against ``repro.resilience``: seeded fault
schedules, retry delays, the fake clock, batch poisoning, checkpoint
corruption bytes, the supervised executor's reports, events and counters,
and the chaos CLI's cells.

Framework-free parts (the schedules, ``RetryPolicy``, ``FakeClock``, the
corruption modes) must be equal to the reference's.  The supervised run
starts from the reference's params and SIL tables, handed across with
``repro_torch.convert`` (the MLP world of ``tests/test_torch_dist.py``):
its control flow (report, events, counters) is equal, its final params in
the fp32 tier (rtol 1e-5, atol 1e-6) but for one hidden unit whose ReLU
flips at one sample in the fault-free runs too (``_assert_fp32_tier``).
Inside the port a recovered run equals the fault-free one **bitwise**, and
a crash whose restore is withheld does not.  The case with two stages on
two cards is marked ``gpu`` and skips below two visible cards.
"""
import os
import shutil
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import repro.resilience as JR
import repro_torch.resilience as R
from repro.dist import StageExecutor as JStageExecutor
from repro.dist import placement as JP
from repro.launch import chaos as j_chaos
from repro.models import mlp as JM
from repro.resilience import faults as JF
from repro.resilience import supervisor as JS
from repro.obs.events import EventLog as JEventLog
from repro.train.backends import MLPBackend as JMLPBackend
from repro.train.backends import balanced_bounds as j_balanced_bounds
from repro.train.backends import make_optimizer_for as j_make_optimizer_for
from repro.verify import scenarios as j_scenarios
from repro_torch.checkpoint import restore_latest_valid
from repro_torch.convert import mlp_params_from_numpy, sil_from_numpy
from repro_torch.dist import StageExecutor, lifecycle, stage_devices
from repro_torch.dist import placement as P
from repro_torch.launch import chaos
from repro_torch.obs.events import EventLog
from repro_torch.optim import read_skipped
from repro_torch.resilience import (FakeClock, FaultSchedule, NaNInjection,
                                    RetryPolicy, StageCrash,
                                    SupervisedExecutor, UnrecoveredFaultError)
from repro_torch.resilience import faults as TF
from repro_torch.resilience.faults import poison_batch
from repro_torch.train.backends import (MLPBackend, balanced_bounds,
                                        make_optimizer_for)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.verify import scenarios
from repro_torch.verify.compare import Bitwise
from _torch_threads import _one_thread  # noqa: F401

N_TICKS = 4
KIND_SETS = [TF.FAULT_KINDS, ("crash", "transient"),
             ("ckpt_corruption", "straggler", "nan")]


def _crash_equivalence_faults(mod):
    """The ``resilience/crash_equivalence`` oracle's schedule, built from
    ``mod`` (either package's faults module)."""
    return [mod.TransientError(stage=0, tick=1, failures=2),
            mod.StageCrash(stage=1, tick=2),
            mod.StragglerDelay(stage=1, tick=3, delay=0.7),
            mod.CheckpointCorruption(stage=0, tick=3,
                                     mode="truncate_manifest")]


# -- the schedule, the retry policy, the clock --------------------------------

@pytest.mark.parametrize("kinds", KIND_SETS, ids=["all", "crash_transient",
                                                  "ckpt_straggler_nan"])
def test_sample_matches_reference(kinds):
    for seed in range(20):
        for n_stages, n_ticks, n_faults in ((2, 4, 3), (3, 6, 5)):
            kw = dict(n_stages=n_stages, n_ticks=n_ticks, n_faults=n_faults,
                      kinds=kinds)
            want = JF.FaultSchedule.sample(seed, **kw)
            got = FaultSchedule.sample(seed, **kw)
            assert got.describe() == want.describe()
            assert got.seed == want.seed == seed
            for a, b in zip(want.faults, got.faults):
                assert repr(a) == repr(b)       # class, fields (nan too)
    with pytest.raises(ValueError, match="unknown fault kinds"):
        FaultSchedule.sample(0, n_stages=2, n_ticks=3, kinds=("meteor",))


def test_consumption_and_transient_countdown_match_reference():
    def drive(mod):
        sched = mod.FaultSchedule(faults=[
            mod.StageCrash(1, 2), mod.TransientError(0, 1, failures=3),
            mod.StragglerDelay(1, 1, delay=0.5),
            mod.CheckpointCorruption(0, 2, mode="flip_bytes"),
            mod.NaNInjection(0, 3)])
        out = [sched.transient_failing(0, 1) for _ in range(5)]
        out += [sched.transient_failing(1, 1)]
        crash = sched.crash_at(1, 2)
        out += [crash.describe(), sched.crash_at(1, 3)]
        sched.consume(crash)
        out += [sched.crash_at(1, 2), sched.straggler_at(1, 1).describe(),
                sched.corruption_at(0, 2).mode,
                [f.describe() for f in sched.unconsumed()]]
        return out
    assert drive(TF) == drive(JF)


def test_retry_delays_and_fake_clock_match_reference():
    for pol in ({}, {"max_retries": 5, "seed": 3},
                {"base": 0.1, "factor": 3.0, "jitter": 0.0}):
        for stage in range(4):
            assert list(RetryPolicy(**pol).delays(stage)) == \
                list(JS.RetryPolicy(**pol).delays(stage))
    clocks = []
    for cls in (FakeClock, JF.FakeClock):
        c = cls(start=1.5)
        c.sleep(0.25)
        c.sleep(-3)
        c.advance(2)
        clocks.append((c.monotonic(), c.sleeps))
    assert clocks[0] == clocks[1] == (3.75, [0.25, 0.0])


def test_poison_batch_copies_and_refuses_int_only():
    x = np.ones((2, 3), np.float32)
    y = np.arange(2)
    out = poison_batch((y, x), float("nan"))
    assert np.isnan(out[1][0, 0]) and np.isnan(out[1]).sum() == 1
    assert np.all(x == 1) and out[0] is y
    np.testing.assert_array_equal(
        JF.poison_batch((y, x), float("nan"))[1], out[1])
    xt = torch.ones((2, 3, 4), dtype=torch.bfloat16)
    yt = torch.arange(2)
    got = poison_batch((yt, xt))
    assert got[1].dtype == torch.bfloat16 and got[1].device == xt.device
    assert torch.isinf(got[1][0, 0, 0]) and int(torch.isinf(got[1]).sum()) \
        == 1
    assert bool((xt == 1).all()) and got[0] is yt
    batch = {"tokens": torch.arange(6).reshape(2, 3),
             "mask": torch.ones(2, 3)}
    got = poison_batch(batch, -1.0)
    assert float(got["mask"][0, 0]) == -1.0
    assert bool((batch["mask"] == 1).all())
    assert got["tokens"] is batch["tokens"]
    for bad in ((yt,), {"tokens": yt}, (np.arange(3),)):
        with pytest.raises(ValueError, match="no floating-point"):
            poison_batch(bad)


# -- checkpoint corruption ----------------------------------------------------

@pytest.mark.parametrize("mode", ["truncate_manifest", "truncate_npz",
                                  "flip_bytes"])
def test_corruption_bytes_match_reference_and_restore_falls_back(tmp_path,
                                                                 mode):
    tree = {"params": [{"w": torch.arange(64, dtype=torch.float32),
                        "b": torch.ones(3, dtype=torch.bfloat16)}],
            "opt": {"count": torch.tensor(2, dtype=torch.int32)}}
    src = str(tmp_path / "src")
    for step in (1, 2):
        lifecycle.save_stage(src, 1, step, tree["params"], tree["opt"])
    roots = [str(tmp_path / name) for name in ("port", "ref")]
    for r in roots:
        shutil.copytree(src, r)
    assert TF.apply_corruption(roots[0], 0, mode) is None   # no stage 0
    paths = [TF.apply_corruption(roots[0], 1, mode),
             JF.apply_corruption(roots[1], 1, mode)]
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    d = [lifecycle.stage_dir(r, 1) for r in roots]
    for name in sorted(os.listdir(d[0])):
        a = open(os.path.join(d[0], name), "rb").read()
        b = open(os.path.join(d[1], name), "rb").read()
        assert a == b, name
    like = {"params": tree["params"], "opt": tree["opt"]}
    got, step = restore_latest_valid(d[0], like)
    assert step == 1
    assert Bitwise().compare(like, got).ok
    with pytest.raises(ValueError, match="unknown corruption mode"):
        TF.apply_corruption(roots[0], 1, "shred")


# -- the supervised executor against the reference ----------------------------

@pytest.fixture(scope="module")
def worlds():
    """The reference's 2-stage MLP world (the crash_equivalence oracle's)
    and the port's built from the same numpy params, SILs and data."""
    cfg, data, jspec = j_scenarios.tiny_mlp(
        n_stages=2, epochs=(N_TICKS,) * 2, n_train=512, batch_size=128)
    jbe = JMLPBackend(cfg, data, jspec, bounds=j_balanced_bounds(cfg, 2))
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    jsils = jbe.make_sils(jax.random.PRNGKey(3), jspec.kappa)
    tcfg, _, spec = scenarios.tiny_mlp(
        n_stages=2, epochs=(N_TICKS,) * 2, n_train=512, batch_size=128)
    be = MLPBackend(tcfg, data, spec, bounds=balanced_bounds(tcfg, 2),
                    device="cpu")
    params = mlp_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    sils = [sil_from_numpy(np.asarray(s), device="cpu") for s in jsils]
    return ((jbe, jbe.split(jparams), jsils, jspec),
            (be, be.split(params), sils, spec))


def _port_ex(world, root, *, nan_guard=False, devices=None):
    be, sp0, sils, spec = world
    if nan_guard:
        spec = replace(spec, nan_guard=True)
    hps = [spec.stage(k) for k in range(2)]
    opts = [make_optimizer_for(hp, spec) for hp in hps]
    devs = devices or stage_devices(2, "cpu")
    return StageExecutor(be, P.round_robin(2, devs), sp0, sils, opts, hps,
                         shuffle=True, ckpt_dir=root)


def _ref_ex(world, root):
    be, sp0, sils, spec = world
    hps = [spec.stage(k) for k in range(2)]
    opts = [j_make_optimizer_for(hp, spec) for hp in hps]
    return JStageExecutor(be, JP.round_robin(2), sp0, sils, opts, hps,
                          shuffle=True, ckpt_dir=root)


def _supervise(ex, schedule, mod, **kw):
    clk = mod.FakeClock()
    kw.setdefault("policy", mod.RetryPolicy(max_retries=4))
    return mod.SupervisedExecutor(ex, schedule=schedule,
                                  clock=clk.monotonic, sleep=clk.sleep,
                                  ckpt_every=1, **kw)


def _log(sup):
    return [(e.kind, e.fields) for e in sup.event_log.records()]


def test_supervised_run_matches_reference(tmp_path, worlds):
    jworld, world = worlds
    jex = _ref_ex(jworld, str(tmp_path / "ref"))
    jsup = _supervise(jex, JF.FaultSchedule(_crash_equivalence_faults(JF)),
                      JR, event_log=JEventLog())
    jsup.run(N_TICKS)
    ex = _port_ex(world, str(tmp_path / "port"))
    sup = _supervise(ex, FaultSchedule(_crash_equivalence_faults(TF)), R,
                     event_log=EventLog())
    sup.run(N_TICKS)
    assert sup.report() == jsup.report()
    assert sup.report()["faults_seen"] == [
        ["transient", 0, 1], ["crash", 1, 2], ["straggler", 1, 3],
        ["transient", 0, 1], ["ckpt_corruption", 0, 3]]
    assert sup.events == jsup.events
    assert _log(sup) == _log(jsup)
    for name in ("supervisor_faults_total", "supervisor_recoveries_total",
                 "supervisor_give_ups_total"):
        assert list(sup.metrics.get(name).rows()) == \
            list(jsup.metrics.get(name).rows()), name
    want = jax.tree.map(np.asarray, jex.gather())
    got = ex.gather()
    for k in range(2):
        for j, layer in enumerate(got[k]):
            for leaf in ("w", "b"):
                _assert_fp32_tier(want[k][j][leaf], layer[leaf].numpy(),
                                  (k, j, leaf))


def _assert_fp32_tier(ref, got, where):
    """The fp32 tier (rtol 1e-5, atol 1e-6) for all but 2% of a leaf's
    elements, the rest within 1e-4.  The fault-free runs of both packages
    differ so too: at the 4th tick one sample's ReLU input at hidden unit
    44 of stage 0's first layer lies within rounding of zero, and that
    unit's incoming weights and bias (1.25% of the leaf) move by 4.3e-6
    (every other element agrees to 6e-8)."""
    err = np.abs(ref - got)
    off = err > 1e-6 + 1e-5 * np.abs(ref)
    assert err.max() <= 1e-4, (where, float(err.max()))
    assert off.sum() <= 0.02 * off.size, (where, int(off.sum()))


# -- inside the port: bitwise, and able to fail -------------------------------

def _fault_free(world, root):
    ex = _port_ex(world, root)
    ex.run(N_TICKS)
    return ex


def test_recovered_run_is_bitwise_and_a_withheld_restore_differs(
        tmp_path, worlds, monkeypatch):
    world = worlds[1]
    ref = _fault_free(world, str(tmp_path / "ref"))
    for seed in (0, 7):
        ex = _port_ex(world, str(tmp_path / f"mixed{seed}"))
        sched = FaultSchedule.sample(seed, n_stages=2, n_ticks=N_TICKS,
                                     kinds=("crash", "transient",
                                            "ckpt_corruption", "straggler"))
        sup = _supervise(ex, sched, R, strict=True)
        sup.run(N_TICKS)
        assert not sup.report()["never_fired"] and not sup.unrecovered
        assert Bitwise().compare(ref.params, ex.params).ok, sched.describe()
        assert Bitwise().compare(ref.opt_states, ex.opt_states).ok
    # the same crash with its restore withheld: the stage goes on from the
    # zeroed state the crash left, and the run ends elsewhere
    ex = _port_ex(world, str(tmp_path / "withheld"))
    sup = _supervise(ex, FaultSchedule([StageCrash(1, 2)]), R)
    restores = []

    def no_restore(k):
        restores.append(k)
        sup.health[k].healthy()
        return True
    monkeypatch.setattr(sup, "_try_restore", no_restore)
    sup.run(N_TICKS)
    assert restores == [1] and ex.ticks == [N_TICKS] * 2
    assert Bitwise().compare(ref.params[0], ex.params[0]).ok
    v = Bitwise().compare(ref.params[1], ex.params[1])
    assert not v.ok and v.metrics["n_diff"] > 0


def test_give_up_strict_raises_lenient_isolates(tmp_path, worlds):
    world = worlds[1]
    sched = FaultSchedule([StageCrash(1, 1)])
    sup = _supervise(_port_ex(world, str(tmp_path / "strict")), sched, R,
                     policy=RetryPolicy(max_retries=0), strict=True)
    with pytest.raises(UnrecoveredFaultError, match="stage 1 unrecovered"):
        sup.run(N_TICKS)
    ex = _port_ex(world, str(tmp_path / "lenient"))
    sup = _supervise(ex, FaultSchedule([StageCrash(1, 1)]), R,
                     policy=RetryPolicy(max_retries=0), strict=False)
    sup.run(N_TICKS)
    rep = sup.report()
    assert rep["health"] == ["ok", "failed"]
    assert rep["ticks"] == [N_TICKS, 1]
    assert rep["unrecovered"] == [[1, "crash at tick 1"]]
    assert sup.metrics.get("supervisor_give_ups_total").total() == 1


def test_nan_skips_count_exactly_under_the_guard(tmp_path, worlds):
    world = worlds[1]
    ex = _port_ex(world, str(tmp_path / "nan"), nan_guard=True)
    sched = FaultSchedule([NaNInjection(0, 1),
                           NaNInjection(0, 3, value=float("nan"))])
    sup = _supervise(ex, sched, R)
    sup.run(N_TICKS)
    assert [int(read_skipped(o)) for o in ex.opt_states] == [2, 0]
    assert sup.report()["faults_seen"] == [] and not sup.unrecovered
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(ex.params))
    # without the guard the poisoned step reaches the params
    ex = _port_ex(world, str(tmp_path / "unguarded"))
    _supervise(ex, FaultSchedule([NaNInjection(0, 1)]), R).run(N_TICKS)
    assert not all(bool(torch.isfinite(t).all())
                   for t in tree_leaves(ex.params[0]))


def test_supervisor_refuses_an_executor_without_ckpt_dir(worlds):
    ex = _port_ex(worlds[1], None)
    with pytest.raises(ValueError, match="needs an executor with ckpt_dir"):
        SupervisedExecutor(ex)


# -- the chaos CLI ------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "full"])
def test_chaos_cells_match_reference(preset):
    for seed in (0, 5):
        want = j_chaos._cell_schedules(j_chaos.PRESETS[preset], seed)
        got = chaos._cell_schedules(chaos.PRESETS[preset], seed)
        assert [(n, s.describe(), g) for n, s, g in got] == \
            [(n, s.describe(), g) for n, s, g in want]


def test_chaos_main_matches_reference(tmp_path, monkeypatch):
    """The port's whole tiny matrix through its CLI; the reference's crash
    and mixed cells alone (its whole matrix takes ~12 s of JAX
    compiles, one executor a cell)."""
    import json
    path = str(tmp_path / "RESILIENCE.json")
    assert chaos.main(["--preset", "tiny", "--device", "cpu", "--json",
                       path]) == 0
    got = json.load(open(path))
    cells = j_chaos._cell_schedules
    monkeypatch.setattr(j_chaos, "_cell_schedules", lambda preset, seed: [
        c for c in cells(preset, seed) if c[0] in ("crash", "mixed/seed0")])
    want = j_chaos.run_matrix("tiny", 0, str(tmp_path / "ref"))
    keys = ("cell", "ok", "faults_seen", "never_fired", "final_ticks",
            "unrecovered", "equivalence")
    assert [c["cell"] for c in want["cells"]] == ["crash", "mixed/seed0"]
    mine = {c["cell"]: {k: c[k] for k in keys} for c in got["cells"]}
    assert [mine[c["cell"]] for c in want["cells"]] == \
        [{k: c[k] for k in keys} for c in want["cells"]]
    assert got["schema"] == want["schema"] and got["n_passed"] == 8
    assert all(c["ok"] and not c["never_fired"] for c in got["cells"])
    assert got["env"]["torch"] == torch.__version__
    assert got["device"] == "cpu"


def test_chaos_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.main(["--preset", "tiny", "--json", ""])


# -- two stages on two cards --------------------------------------------------

@pytest.mark.gpu
def test_crash_recovery_on_two_cards_is_bitwise(tmp_path, worlds):
    """Stage 1 on the second card crashes and recovers from its own
    checkpoint; the run equals the fault-free run on the same two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    be0, sp0, sils, spec = worlds[1]
    be = MLPBackend(be0.cfg, scenarios.tiny_mlp(
        n_stages=2, epochs=(N_TICKS,) * 2, n_train=512,
        batch_size=128)[1], spec, bounds=be0.bounds, device="cuda")
    world = (be, tree_map(lambda t: t.cuda(), sp0),
             [s.cuda() for s in sils], spec)
    devs = stage_devices(2, "cuda")
    ref = _port_ex(world, str(tmp_path / "ref"), devices=devs)
    ref.run(N_TICKS)
    ex = _port_ex(world, str(tmp_path / "chaos"), devices=devs)
    sup = _supervise(ex, FaultSchedule(_crash_equivalence_faults(TF)), R)
    sup.run(N_TICKS)
    assert not sup.unrecovered and not sup.report()["never_fired"]
    assert Bitwise().compare(ref.gather(), ex.gather()).ok
    assert ex.params[1][0]["w"].device == devs[1]
