"""The port's training path (the paper's MLP experiment) against the
reference package on the same numpy inputs.

Params and SIL tables come from the reference's ``init_params`` /
``make_sil`` and are handed across with ``repro_torch.convert``; data and
batch orders are numpy in both packages and must match bit for bit.  fp32
results are held at the ``tolerance_for(float32)`` tier (rtol 1e-5, atol
1e-6): the two frameworks sum matmuls in other orders, which moves a loss by
~1e-7 relative after an epoch.  bf16 compute is held at the bf16 tier
(rtol 2e-2, atol 2e-2).  Test accuracies of whole runs may differ by two of
the test samples (2/n_test), since a logit within rounding of a tie can
fall either way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as JL
from repro.core import sil as JS
from repro.data.images import emnist_like as j_emnist_like
from repro.data.loader import Batches as JBatches
from repro.models import mlp as JM
from repro.optim import sgd_momentum as j_sgdm
from repro.train import backends as JB
from repro.train import phases as JP
from repro.train import recipes as JRc
from repro.train import trainer as JT
from repro.verify import scenarios
from repro_torch.convert import mlp_params_from_numpy, sil_from_numpy
from repro_torch.core import losses as TL
from repro_torch.core import sil as TS
from repro_torch.data.images import emnist_like
from repro_torch.data.loader import Batches
from repro_torch.models import mlp as TM
from repro_torch.optim import (make_optimizer, read_skipped, sgd_momentum,
                               step_guard)
from repro_torch.train import backends as TB
from repro_torch.train import phases as TP
from repro_torch.train import recipes as TRc
from repro_torch.train import trainer as TT
from repro_torch.train.boundary import BoundaryCache
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.verify.compare import Allclose, tolerance_for

FP32 = Allclose()                   # the float32 tier of tolerance_for
CFG = TM.MLPConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_spec(spec) -> TrainSpec:
    """The reference's TrainSpec as the port's (same fields)."""
    def stage(s):
        return None if s is None else StageSpec(**dataclasses.asdict(s))
    d = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    d.update(stages=tuple(stage(s) for s in spec.stages),
             baseline=stage(spec.baseline), recovery=stage(spec.recovery))
    return TrainSpec(**d)


def _params_np(key, cfg=None):
    return jax.tree.map(np.asarray, JM.init_params(cfg or JM.MLPConfig(),
                                                   key))


def _flat_ref(params):
    """The reference's params as a list in the port's leaf order (w, b)."""
    return [np.asarray(p[k]) for p in params for k in ("w", "b")]


# -- data ---------------------------------------------------------------------

def test_emnist_like_is_bit_identical():
    for got, want in zip(emnist_like(300, 70, seed=3, noise=0.7),
                         j_emnist_like(300, 70, seed=3, noise=0.7)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_order_is_bit_identical(legacy, drop_last):
    x = np.arange(103 * 3, dtype=np.float32).reshape(103, 3)
    y = np.arange(103, dtype=np.int32)
    kw = dict(batch_size=16, shuffle=True, seed=5, drop_last=drop_last,
              legacy_seeding=legacy)
    ref, port = JBatches((x, y), **kw), Batches((x, y), device="cpu", **kw)
    assert len(ref) == len(port)
    for ep in (0, 1):
        got = list(port.epoch(ep))
        want = list(ref.epoch(ep))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert isinstance(gx, torch.Tensor)
            assert np.array_equal(gx.numpy(), wx)
            assert np.array_equal(gy.numpy(), wy)


# -- SIL, losses, model --------------------------------------------------------

def test_sil_tables_and_lookup():
    g = torch.Generator().manual_seed(0)
    sil = TS.make_sil(g, 60, 47, 10.0)
    assert sil.shape == (60, 47) and sil.dtype == torch.float32
    assert 0.0 <= sil.min() and sil.max() < 10.0
    a, b = TS.make_stage_sils(torch.Generator().manual_seed(1), [60, 30], 47,
                              2.0)
    assert a.shape == (60, 47) and b.shape == (30, 47)
    assert not torch.equal(a[:30], b)       # drawn in turn, not repeated
    jsil = JS.make_sil(jax.random.PRNGKey(0), 8, 5, 3.0)
    lab = np.array([[0, 4, 2], [1, 1, 3]], np.int32)
    np.testing.assert_array_equal(
        TS.sil_lookup(sil_from_numpy(np.asarray(jsil), device="cpu"),
                      _t(lab)).numpy(),
        np.asarray(JS.sil_lookup(jsil, jnp.asarray(lab))))


def test_losses_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 6, 12)).astype(np.float32) * 3
    labels = rng.integers(0, 10, size=(4, 6)).astype(np.int32)
    mask = (rng.uniform(size=(4, 6)) > 0.3).astype(np.float32)
    for kw in ({}, {"vocab_size": 10}):
        for m in (None, mask):
            want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m),
                                    **kw)
            got = TL.cross_entropy(_t(logits), _t(labels),
                                   None if m is None else _t(m), **kw)
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
            want = JL.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
            got = TL.accuracy(_t(logits), _t(labels),
                              None if m is None else _t(m))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    act = rng.normal(size=(2, 5, 8)).astype(np.float32)
    sil = rng.uniform(size=(8, 12)).astype(np.float32) * 10
    np.testing.assert_allclose(
        TL.sil_stage_loss(_t(act), _t(sil), _t(labels[:2, :5])).item(),
        float(JL.sil_stage_loss(jnp.asarray(act), jnp.asarray(sil),
                                jnp.asarray(labels[:2, :5]))), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="MoE"):
        TL.train_objective(type("C", (), {"moe": object()})(), _t(logits),
                           _t(labels), {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_range_per_stage_matches_reference(dtype):
    params = _params_np(jax.random.PRNGKey(0))
    tparams = mlp_params_from_numpy(CFG, params, device="cpu")
    x = np.random.default_rng(1).uniform(size=(64, 784)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    rtol, atol = tolerance_for(dtype)
    for lo, hi in ((0, CFG.cut), (CFG.cut, CFG.n_layers),
                   (0, CFG.n_layers)):
        xin = x if lo == 0 else np.abs(x[:, :CFG.sizes[lo]])
        want = JM.forward_range(JM.MLPConfig(), params[lo:hi],
                                jnp.asarray(xin), lo, hi, compute_dtype=jdt)
        got = TM.forward_range(CFG, tparams[lo:hi], _t(xin), lo, hi,
                               compute_dtype=tdt)
        assert got.dtype == (tdt or torch.float32)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol)
    assert TM.macs(CFG) == JM.macs(JM.MLPConfig())
    assert TM.macs(CFG, 0, 2) == JM.macs(JM.MLPConfig(), 0, 2)


def test_init_params_shapes_and_bounds():
    params = TM.init_params(CFG, torch.Generator().manual_seed(0))
    ref = _params_np(jax.random.PRNGKey(0))
    for p, r in zip(params, ref):
        assert p["w"].shape == r["w"].shape and p["b"].shape == r["b"].shape
        bound = 1.0 / np.sqrt(p["w"].shape[0])
        assert p["w"].abs().max() <= bound and p["b"].abs().max() <= bound


# -- optimizer -----------------------------------------------------------------

def test_sgd_momentum_matches_reference_over_steps():
    rng = np.random.default_rng(2)
    params = [{"w": rng.normal(size=(5, 3)).astype(np.float32),
               "b": rng.normal(size=(3,)).astype(np.float32)}]
    grads = [[{"w": rng.normal(size=(5, 3)).astype(np.float32),
               "b": rng.normal(size=(3,)).astype(np.float32)}]
             for _ in range(4)]
    jopt, topt = j_sgdm(0.05, 0.9), sgd_momentum(0.05, 0.9)
    jp = jax.tree.map(jnp.asarray, params)
    tp = [{k: _t(v) for k, v in d.items()} for d in params]
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update([_t(g[0]["w"]), _t(g[0]["b"])], ts, tp)
    assert FP32.compare(_flat_ref(jax.tree.map(np.asarray, jp)), tp).ok
    assert FP32.compare([np.asarray(js["mu"][0][k]) for k in ("w", "b")],
                        ts["mu"]).ok
    assert int(ts["count"]) == int(js["count"]) == 4
    with pytest.raises(NotImplementedError):
        make_optimizer("adamw", 1e-3)


def test_schedules_match_reference():
    from repro.optim import schedules as JSch
    from repro_torch.optim import schedules as TSch
    for step in (0, 3, 10, 57, 100, 250):
        for j, t in ((JSch.constant(0.01), TSch.constant(0.01)),
                     (JSch.cosine_warmup(0.1, 10, 200),
                      TSch.cosine_warmup(0.1, 10, 200))):
            np.testing.assert_allclose(
                float(t(torch.tensor(step, dtype=torch.int32))),
                float(j(jnp.int32(step))), rtol=1e-6)
    # a schedule as the optimizer's lr, read from the state's count
    p = [torch.ones(2)]
    opt = sgd_momentum(TSch.cosine_warmup(0.1, 2, 10), 0.0)
    st = opt.init(p)
    opt.update([torch.ones(2)], st, p)
    np.testing.assert_allclose(p[0].numpy(), 1 - 0.05, rtol=1e-6)


def test_step_guard_skips_non_finite_steps_on_the_device():
    p = [torch.ones(3), torch.zeros(2)]
    opt = step_guard(sgd_momentum(0.1, 0.9))
    st = opt.init(p)
    opt.update([torch.ones(3), torch.ones(2)], st, p)
    snap = [t.clone() for t in p], [t.clone() for t in st["inner"]["mu"]]
    opt.update([torch.tensor([1.0, float("nan"), 1.0]), torch.ones(2)], st, p)
    assert all(torch.equal(a, b) for a, b in zip(p, snap[0]))
    assert all(torch.equal(a, b) for a, b in zip(st["inner"]["mu"], snap[1]))
    assert int(read_skipped(st)) == 1 and int(st["inner"]["count"]) == 1


# -- metrics, boundary ------------------------------------------------------------

def test_trainer_observes_every_step_loss_and_numbers_evaluations(world):
    """The loss histogram holds each step loss the History holds, and an
    evaluation record carries the index of the last step before it."""
    cfg, data, spec, params, sil = world
    tspec = _port_spec(spec)
    tt = TT.Trainer(TB.MLPBackend(CFG, data, tspec, device="cpu"), tspec)
    _, th = tt.run([TP.SilStagePhase(stage=0, epochs=2),
                    TP.BoundaryMaterializePhase(upto=1),
                    TP.FrozenPrefixPhase(stage=1, epochs=2)],
                   params=mlp_params_from_numpy(
                       CFG, jax.tree.map(np.asarray, params), device="cpu"),
                   sils=[sil_from_numpy(np.asarray(sil), device="cpu")])
    losses = th.column("loss")
    hist = tt.metrics.get("train_loss")
    assert hist.total == len(losses) == 32          # 2 phases x 2 x 8 steps
    assert hist.max == max(losses) and hist.min == min(losses)
    np.testing.assert_allclose(hist.sum, sum(losses), rtol=1e-12)
    evals = [(r.phase, r.step) for r in th.records if r.acc is not None]
    assert evals and all(step in (7, 15) for _, step in evals)
    assert ("right", 15) in evals                   # cadence+last


def test_boundary_cache_spills_and_round_trips(tmp_path):
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(10, 4).to(dtype)
        c = BoundaryCache(spill_dir=str(tmp_path))
        c.reserve(10, (4,), dtype)
        c.append(x[:6])
        c.append(x[6:])
        assert c.spilled and c.nbytes == 10 * 4 * x.element_size()
        assert torch.equal(c.tensor("cpu"), x)
        with pytest.raises(ValueError, match="overflow"):
            c.append(x[:1])
        c.close()
    assert not list(tmp_path.iterdir())


# -- phases: one epoch each, against the reference's ---------------------------

@pytest.fixture(scope="module")
def world():
    cfg, data, spec = scenarios.tiny_mlp(n_stages=2, epochs=(1, 1),
                                         baseline_epochs=1)
    spec = dataclasses.replace(spec, shuffle=True)
    kp, ks = jax.random.split(jax.random.PRNGKey(3))
    params = JM.init_params(cfg, kp)
    sil = JS.make_sil(ks, cfg.boundary_width, cfg.n_classes, spec.kappa)
    return cfg, data, spec, params, sil


def _run_both(world, jphases, tphases, policy=None):
    """Both Trainers over the same phases, params, SIL and data.  Returns
    (reference per-step losses, reference params, history), (port ...)."""
    cfg, data, spec, params, sil = world
    spec = dataclasses.replace(spec, precision=policy)
    jt = JT.Trainer(JB.MLPBackend(cfg, data, spec), spec)
    seen = []                       # the reference's device-side losses
    jt._loss_hist.observe_device = lambda v: seen.append(np.asarray(v))
    jp, jh = jt.run(jphases, params=params, sils=[sil])
    tspec = _port_spec(spec)
    tt = TT.Trainer(TB.MLPBackend(CFG, data, tspec, device="cpu"), tspec)
    tparams = mlp_params_from_numpy(CFG, jax.tree.map(np.asarray, params),
                                    device="cpu")
    tp, th = tt.run(tphases, params=tparams,
                    sils=[sil_from_numpy(np.asarray(sil), device="cpu")])
    # the caller's tensors are never updated in place
    assert FP32.compare(_flat_ref(jax.tree.map(np.asarray, params)),
                        tparams).ok
    return ((np.concatenate(seen), _flat_ref(jax.tree.map(np.asarray, jp)),
             jh), (np.asarray(th.column("loss"), np.float32), tp, th))


PHASES = {
    "baseline": lambda P: [P.BaselinePhase()],
    "sil_stage0": lambda P: [P.SilStagePhase(stage=0)],
    "materialize+frozen_prefix1": lambda P: [
        P.BoundaryMaterializePhase(upto=1),
        P.FrozenPrefixPhase(stage=1, source="cache")],
    # the boundary spilled to a memmap, then read back for the right phase
    "materialize_spilled+frozen_prefix1": lambda P: [
        P.BoundaryMaterializePhase(upto=1, spill_threshold_bytes=0),
        P.FrozenPrefixPhase(stage=1, source="cache")],
    "recovery0": lambda P: [P.RecoveryPhase(stage=0, epochs=1)],
    # two microbatches of 64, grads summed in fp32
    "sil_stage0_accum2": lambda P: [P.SilStagePhase(stage=0, accum=2)],
    # the NaN/inf step guard around sgdm, on clean steps
    "baseline_guarded": lambda P: [P.BaselinePhase(nan_guard=True)],
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_one_epoch_of_each_phase_matches_reference(world, name):
    (jl, jp, jh), (tl, tp, th) = _run_both(world, PHASES[name](JP),
                                           PHASES[name](TP))
    assert len(tl) == len(jl) == 8            # 1024 samples / 128
    verdict = FP32.compare(jl, tl)
    assert verdict.ok, verdict.detail
    verdict = FP32.compare(jp, tp)
    assert verdict.ok, verdict.detail
    assert th.column("macs") == jh.column("macs")
    assert th.column("acc") == pytest.approx(jh.column("acc"), abs=1e-7)


def test_bf16_sil_stage_epoch_matches_reference(world):
    """bf16 compute (fp32 params): the kernel path's bf16 act and grad."""
    (jl, jp, _), (tl, tp, _) = _run_both(
        world, PHASES["sil_stage0"](JP), PHASES["sil_stage0"](TP),
        policy="bf16")
    bf16 = Allclose(*tolerance_for("bfloat16"))
    assert bf16.compare(jl, tl).ok
    assert bf16.compare(jp, tp).ok


def test_fp32_training_pins_tf32_off(world, monkeypatch):
    cfg, data, spec, _, _ = world
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    TB.MLPBackend(CFG, data, _port_spec(spec), device="cpu")   # no policy
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_recovery_freezes_the_other_stages(world):
    cfg, data, spec, params, sil = world
    tspec = _port_spec(spec)
    be = TB.MLPBackend(CFG, data, tspec, device="cpu")
    stages = be.split(mlp_params_from_numpy(
        CFG, jax.tree.map(np.asarray, params), device="cpu"))
    before = [t.clone() for t in stages[1][0].values()]
    opt = sgd_momentum(0.01, 0.9)
    step = be.build_recovery_step(0, stages, opt)
    x, y = [b[0] for b in be.epoch_arrays(0, True)]
    step(stages[0], opt.init(stages[0]), x, y)
    for t, b in zip(stages[1][0].values(), before):
        assert torch.equal(t, b) and t.grad is None and not t.requires_grad


# -- whole sequences at a tiny size -----------------------------------------------

def test_fig3_and_baseline_sequences_match_reference():
    """Fig. 3 + §5 recovery and the baseline, 512 samples, 2 epochs each at
    the paper's learning rates: MACs equal, accuracies within 2/n_test."""
    n_test = 256
    data = j_emnist_like(n_train=512, n_test=n_test, seed=0, noise=0.5)
    kw = dict(n_left=2, n_right=2, n_baseline=2, n_recovery=2, batch_size=64)
    jspec, tspec = JRc.paper_spec(**kw), TRc.paper_spec(**kw)
    cfg = JM.MLPConfig()
    key = jax.random.PRNGKey(1)
    _, jh = JRc.run_mlp_fig3(cfg, data, jspec, key)
    kp, ks = jax.random.split(key)
    _, th = TRc.run_mlp_fig3(
        CFG, data, tspec, device="cpu",
        params=mlp_params_from_numpy(CFG, _params_np(kp), device="cpu"),
        sil=sil_from_numpy(np.asarray(JS.make_sil(
            ks, cfg.boundary_width, cfg.n_classes, jspec.kappa)),
            device="cpu"))
    _, jb = JRc.run_mlp_baseline(cfg, data, jspec, jax.random.PRNGKey(0))
    _, tb = TRc.run_mlp_baseline(
        CFG, data, tspec, device="cpu",
        params=mlp_params_from_numpy(CFG, _params_np(jax.random.PRNGKey(0)),
                                     device="cpu"))
    for j, t in ((jh, th), (jb, tb)):
        assert t.column("macs") == j.column("macs")
        assert [r.phase for r in t.records if r.acc is not None] == \
            [r.phase for r in j.records]
        np.testing.assert_allclose(t.column("acc"), j.column("acc"),
                                   atol=2 / n_test)
    # 4 phases x 2 epochs x 8 steps of losses, all finite
    assert len(th.column("loss")) == 48 and np.isfinite(th.column("loss")).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PHASES))
def test_one_epoch_of_each_phase_on_the_card_matches_the_cpu(world, name):
    """The same phase on the card (kernels, cuBLAS) and on the CPU (plain
    versions): per-step losses and params within the float32 tier scaled
    for two GEMM libraries (rtol 1e-4, atol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import dispatch
    cfg, data, spec, params, sil = world
    tspec = _port_spec(spec)
    out = {}
    for dev in ("cpu", "cuda"):
        be = TB.MLPBackend(CFG, data, tspec, device=dev)
        dispatch.LAUNCHES.reset()
        tp, th = TT.Trainer(be, tspec).run(
            PHASES[name](TP),
            params=mlp_params_from_numpy(CFG, jax.tree.map(np.asarray,
                                                           params),
                                         device=dev),
            sils=[sil_from_numpy(np.asarray(sil), device=dev)])
        out[dev] = (th.column("loss"), tp, dispatch.LAUNCHES.get("sil_mse"))
    close = Allclose(1e-4, 1e-6)
    assert close.compare(out["cpu"][0], out["cuda"][0]).ok
    assert close.compare(out["cpu"][1], out["cuda"][1]).ok
    assert out["cpu"][2] == 0
    assert (out["cuda"][2] > 0) == name.startswith("sil_stage0")
