"""The paper's Fig. 5 (every stage at once) in the port against the
reference: ``recipes.run_mlp_fig5`` and ``recipes.run_lm_parallel`` on the
same numpy inputs as ``repro``'s, and the launcher's Fig.-5, checkpoint
and resume paths on the CPU.

Params and SIL tables are the reference's, drawn from its key schedule
(MLP: ``split(key, n_stages + 2)``, params from keys[0] and SIL k from
keys[1 + k]; LM: ``split(key, n_stages)``) and handed across with
``repro_torch.convert``.  fp32 is held at the ``tolerance_for(float32)``
tier (rtol 1e-5, atol 1e-6), bf16 compute at the bf16 tier (2e-2); the
joined MLP's accuracy may differ by two test samples (a logit within
rounding of a tie); LM params after AdamW steps as in
``tests/test_torch_lm_train.py``: all but 1% of each leaf's elements at the
fp32 tier, the rest within 2 lr a step (an element with a gradient at
rounding level moves by up to lr either way).  The reference's MLP phase
logs no step losses; its executor observes each stage's epoch losses into
a device histogram, which the test reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.metrics as JMetrics
from repro.configs import get as j_get
from repro.core import sil as JS
from repro.models import mlp as JM
from repro.models import model as JMod
from repro.train import StageSpec as JStageSpec
from repro.train import TrainSpec as JTrainSpec
from repro.train import recipes as JRc
from repro.train.backends import balanced_bounds as j_balanced_bounds
from repro_torch.configs import get
from repro_torch.convert import (mlp_params_from_numpy, params_from_numpy,
                                 sil_from_numpy)
from repro_torch.data.images import emnist_like
from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
from repro_torch.launch import train as launch_train
from repro_torch.models import mlp as TM
from repro_torch.train import recipes
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.verify.compare import Allclose
from _torch_threads import _one_thread  # noqa: F401

FP32 = Allclose()
BF16 = Allclose(rtol=2e-2, atol=2e-2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, dtype=np.float32)}


def _port_layout(tree):
    """A reference tree with ``groups`` unstacked into a list."""
    out = {}
    for k, v in tree.items():
        if k == "groups":
            n = len(jax.tree_util.tree_leaves(v)[0])
            out[k] = [jax.tree_util.tree_map(lambda a, g=g: np.asarray(a[g]),
                                             v) for g in range(n)]
        else:
            out[k] = jax.tree_util.tree_map(np.asarray, v)
    return out


def _assert_adamw_params(ref_tree, port_tree, lr, steps):
    ref, got = _flat(_port_layout(ref_tree)), _flat(port_tree)
    assert sorted(ref) == sorted(got)
    bound = 2 * lr * steps
    for k in ref:
        err = np.abs(ref[k] - got[k])
        assert err.max() <= bound, f"{k}: max|err| {err.max()} > {bound}"
        if k.endswith("attn/wk/b"):
            continue
        off = err > 1e-6 + 1e-5 * np.abs(ref[k])
        assert off.sum() <= 1e-2 * off.size, \
            f"{k}: {off.sum()} of {off.size} elements off the tier"


# -- the MLP ------------------------------------------------------------------

def _mlp_specs(epochs):
    kw = dict(batch_size=128, kappa=10.0, n_stages=len(epochs))
    return (JTrainSpec(stages=tuple(JStageSpec(epochs=e, lr=0.01)
                                    for e in epochs), **kw),
            TrainSpec(stages=tuple(StageSpec(epochs=e, lr=0.01)
                                   for e in epochs), **kw))


@pytest.mark.parametrize("epochs,dist", [((2, 2, 2), None),
                                         ((1, 2, 1), "round_robin")],
                         ids=["loop", "executor"])
def test_run_mlp_fig5_matches_reference(monkeypatch, epochs, dist):
    n, n_test = len(epochs), 128
    data = emnist_like(n_train=1024, n_test=n_test, seed=0, noise=0.5)
    jspec, tspec = _mlp_specs(epochs)
    cfg, tcfg = JM.MLPConfig(), TM.MLPConfig()
    key = jax.random.PRNGKey(5)
    seen = []                                 # the reference's epoch losses
    orig = JMetrics.DeviceHistogram.observe_device

    def observe(self, values):
        seen.append(np.asarray(values))
        return orig(self, values)
    monkeypatch.setattr(JMetrics.DeviceHistogram, "observe_device", observe)
    jp, jh = JRc.run_mlp_fig5(cfg, data, jspec, key, n_stages=n,
                              dist="round_robin")
    keys = jax.random.split(key, n + 2)
    bounds = j_balanced_bounds(cfg, n)
    sils = [sil_from_numpy(np.asarray(JS.make_sil(
        keys[1 + k], cfg.sizes[bounds[k][1]], cfg.n_classes, jspec.kappa)),
        device="cpu") for k in range(n - 1)]
    params = mlp_params_from_numpy(tcfg, jax.tree.map(
        np.asarray, JM.init_params(cfg, keys[0])), device="cpu")
    tp, th = recipes.run_mlp_fig5(tcfg, data, tspec, n_stages=n,
                                  params=params, sils=sils, dist=dist,
                                  dist_devices=[torch.device("cpu")] * 2,
                                  device="cpu")
    # the reference's executor observes (epoch, stage) in tick order
    order = [(ep, k) for ep in range(max(epochs)) for k in range(n)
             if ep < epochs[k]]
    assert len(seen) == len(order)
    for k in range(n):
        want = np.concatenate([v for (ep, s), v in zip(order, seen)
                               if s == k])
        got = np.asarray(th.column("loss", stage=k), np.float32)
        assert len(got) == epochs[k] * 8
        v = FP32.compare(want, got)
        assert v.ok, f"stage {k}: {v.detail}"
    ref = [np.asarray(p[x]) for p in jp for x in ("w", "b")]
    v = FP32.compare(ref, [t for p in tp for t in (p["w"], p["b"])])
    assert v.ok, v.detail
    jacc = [r.acc for r in jh.records if r.acc is not None]
    tacc = [r.acc for r in th.records if r.acc is not None]
    assert len(jacc) == len(tacc) == 1
    assert abs(jacc[0] - tacc[0]) <= 2 / n_test
    assert th.column("macs") == [m for m in jh.column("macs")]


# -- the LM ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    jcfg = j_get("qwen2-1.5b", smoke=True)
    cfg = get("qwen2-1.5b", smoke=True)
    jparams = JMod.init_params(jcfg, jax.random.PRNGKey(0))
    stream = synthetic_token_stream(20_000, cfg.vocab_size, seed=0)
    return jcfg, cfg, jparams, stream


def _lm_specs(steps, precision, lr=1e-3):
    kw = dict(n_stages=2, kappa=1.0, precision=precision)
    return (JTrainSpec(stages=tuple(JStageSpec(steps=steps, lr=lr,
                                               optimizer="adamw")
                                    for _ in range(2)), **kw),
            TrainSpec(stages=tuple(StageSpec(steps=steps, lr=lr,
                                             optimizer="adamw")
                                   for _ in range(2)), **kw))


@pytest.mark.parametrize("precision,dist", [("fp32", None),
                                            ("fp32", "round_robin"),
                                            ("bf16", None)])
def test_run_lm_parallel_matches_reference(lm, precision, dist):
    """2 stages x 3 steps at once: every logged (step, stage) loss at the
    precision's tier, and the joined params."""
    jcfg, cfg, jparams, stream = lm
    jcfg, cfg = (c.replace(dtype="float32") if precision == "fp32" else c
                 for c in (jcfg, cfg))
    jspec, tspec = _lm_specs(3, precision)
    key = jax.random.PRNGKey(1)

    def jbatch(i):
        return {k: jnp.asarray(v) for k, v in
                lm_batch_at(stream, 2, 32, i).items()}
    jjoined, jh = JRc.run_lm_parallel(jcfg, 2, jparams, jbatch, jspec, key)
    sil = sil_from_numpy(np.asarray(JS.make_sil(
        jax.random.split(key, 2)[0], jcfg.d_model, jcfg.vocab_size, 1.0)),
        device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    joined, th = recipes.run_lm_parallel(
        cfg, 2, params, lambda i: lm_batch_at(stream, 2, 32, i), tspec,
        sils=[sil.t().contiguous().t()], dist=dist,
        dist_devices=[torch.device("cpu")] * 2, device="cpu")
    for col in ("phase", "stage", "step"):
        assert th.column(col) == jh.column(col)
    assert [(r.step, r.stage) for r in th.records] == \
        [(i, k) for i in range(3) for k in range(2)]
    policy = FP32 if precision == "fp32" else BF16
    v = policy.compare(np.asarray(jh.column("loss"), np.float32),
                       np.asarray(th.column("loss"), np.float32))
    assert v.ok, v.detail
    if precision == "fp32":
        _assert_adamw_params(jjoined, joined, 1e-3, 3)
    else:
        ref, got = _flat(_port_layout(jjoined)), _flat(joined)
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert policy.compare(ref[k], got[k]).ok, k


def test_parallel_lm_does_not_refresh_the_tied_copy(lm):
    """As in the reference, the last stage trains against the tied copy it
    was split with: stage 0's trained embedding never reaches it."""
    _, cfg, jparams, stream = lm
    from repro_torch.core import partition
    from repro_torch.train import LMBackend, ParallelSilPhase, Trainer
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    spec = _lm_specs(2, "fp32")[1]
    be = LMBackend(cfg, partition.make_plan(cfg, 2),
                   lambda i: lm_batch_at(stream, 2, 32, i), spec,
                   device="cpu")
    seen = []
    orig = be.build_stage_step

    def spy(k, opt, sil, accum=1):
        step = orig(k, opt, sil, accum)

        def wrapped(sp, st, *a):
            if k == 1:
                seen.append(sp["tied_unembed"].clone())
            return step(sp, st, *a)
        return wrapped
    be.build_stage_step = spy
    joined, _ = Trainer(be, spec).run(
        [ParallelSilPhase()], params=params,
        gen=torch.Generator().manual_seed(1))
    assert len(seen) == 2
    for t in seen:
        assert torch.equal(t, params["tok_embed"])
    assert not torch.equal(joined["tok_embed"], params["tok_embed"])


# -- the launcher -----------------------------------------------------------------

def test_cli_paper_mlp_fig5(capsys):
    params, hist = launch_train.main(["--arch", "paper_mlp", "--smoke",
                                      "--mode", "pnn", "--steps", "1",
                                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "stage0: layers[0,2)" in out and "stage1: layers[2,4)" in out
    assert "paper_mlp pnn: test acc" in out
    assert set(hist.column("phase")) == {"parallel"}
    # 9400 samples / 1410 = 6 steps an epoch, per stage
    assert [len(hist.column("loss", stage=k)) for k in (0, 1)] == [6, 6]
    assert np.isfinite(hist.column("loss")).all()


def test_cli_lm_dist_checkpoints_then_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    _, hist = launch_train.main([
        "--arch", "qwen2-1.5b", "--smoke", "--mode", "pnn", "--dist",
        "round_robin", "--steps", "2", "--batch", "2", "--seq", "32",
        "--ckpt-dir", ck, "--ckpt-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dist=round_robin over 2 devices" in out and "saved:" in out
    assert [(r.step, r.stage) for r in hist.records] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    from repro_torch.checkpoint import available_steps, latest_step
    from repro_torch.dist import lifecycle
    assert lifecycle.stage_ticks(str(tmp_path / "ck" / "stages"), 2) == [2, 2]
    assert available_steps(lifecycle.stage_dir(
        str(tmp_path / "ck" / "stages"), 1)) == [1, 2]
    assert latest_step(ck) == 2
    params, _ = launch_train.main([
        "--arch", "qwen2-1.5b", "--smoke", "--mode", "pnn", "--steps", "2",
        "--batch", "2", "--seq", "32", "--resume", ck, "--ckpt-dir",
        str(tmp_path / "ck2"), "--device", "cpu"])
    assert "resumed params from" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "ck2")) == 4      # 2 + 2 steps


@pytest.mark.parametrize("argv,err", [
    # the searched cut is ported: Fig. 5 runs on the reference's bounds
    (["--mode", "pnn", "--dist", "round_robin", "--stages", "auto:2",
      "--steps", "2", "--batch", "2", "--seq", "16"], None),
    (["--mode", "pnn", "--dist", "memory", "--seq-shard"], SystemExit),
    (["--arch", "paper_mlp", "--mode", "baseline", "--dist", "memory"],
     SystemExit),
], ids=["dist-auto", "dist-seq-shard", "mlp-dist-without-pnn"])
def test_cli_still_refuses(argv, err, capsys):
    """What is not ported raises; ``--stages auto:2`` under ``--dist``
    (``err`` None) trains both stages at once on the bounds the reference's
    searcher gives the smoke qwen2."""
    if err is not None:
        with pytest.raises(err):
            launch_train.main(["--smoke", "--device", "cpu"] + argv)
        return
    _, hist = launch_train.main(["--smoke", "--device", "cpu"] + argv)
    from repro.core import partition as JPart
    bounds = JPart.make_plan(j_get("qwen2-1.5b", smoke=True), 2,
                             strategy="auto").bounds
    assert f"plan[auto]: 2 stages, searched bounds {bounds}" in \
        capsys.readouterr().out
    assert [(r.step, r.stage) for r in hist.records] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_fig5_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = emnist_like(n_train=256, n_test=32, seed=0)
    spec = _mlp_specs((1, 1, 1))[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        recipes.run_mlp_fig5(TM.MLPConfig(), data, spec)
    cfg = get("qwen2-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        recipes.run_lm_parallel(cfg, 2, None, None, _lm_specs(1, None)[1])
    for argv in (["--arch", "paper_mlp", "--mode", "pnn"],
                 ["--mode", "pnn", "--dist", "round_robin"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--smoke"] + argv)
