"""The port's LM training path (stage-sequential PNN with synthetic
intermediate labels on qwen2-1.5b's smoke config: 2 layers, d 256, 4/2
heads of 64, vocab 512) against the reference package on the same numpy
inputs.

Params and SIL tables come from the reference's ``init_params`` /
``make_sil`` and are handed across with ``repro_torch.convert``; the token
data is numpy in both packages and must match bit for bit.  fp32 results are
held at the ``tolerance_for(float32)`` tier (rtol 1e-5, atol 1e-6): the two
frameworks sum matmuls and reductions in other orders.  Activations and
logits take the tier's rtol with an atol of 1e-5 of the tensor's largest
magnitude, since a matmul's summation-order error scales with its output,
not with each element.  Params after AdamW steps: AdamW's first steps move
an element by about lr * g / (|g| + eps), so an element whose gradient is at
rounding level (|g| near eps) moves by anything up to lr in either
direction on a rounding difference.  All but 1% of each leaf's elements
must hold the fp32 tier and the rest lie within 2 lr a step of the
reference.  The key projection has many such elements (the softmax over
keys ignores a shift of every score of a query, so the part of its gradient
along that shift cancels: 0.2% of stage 1's ``wk`` after three steps), and
the key bias, whose gradient is zero in exact arithmetic, is held only to
the 2 lr bound.  bf16 compute is held at the bf16 tier
(rtol 2e-2, atol 2e-2).  On the CPU the attention runs its plain version in
both packages (``ref.chunked_attention``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JPlan
from repro.configs import get as j_get
from repro.core import partition as JP
from repro.core import sil as JS
from repro.data import lm as JD
from repro.models import model as JM
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.optim import optimizers as JO
from repro.train import BaselinePhase as JBaselinePhase
from repro.train import LMBackend as JLMBackend
from repro.train import StageSpec as JStageSpec
from repro.train import TrainSpec as JTrainSpec
from repro.train import Trainer as JTrainer
from repro.train import recipes as JRc
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy, sil_from_numpy
from repro_torch.core import losses as TL
from repro_torch.core import partition as TP
from repro_torch.data import lm as TD
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO
from repro_torch.train import BaselinePhase, LMBackend, Trainer, recipes
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.tree import tree_map
from repro_torch.verify.compare import Allclose
from _torch_threads import _one_thread  # noqa: F401

FP32 = Allclose()                          # rtol 1e-5, atol 1e-6
BF16 = Allclose(rtol=2e-2, atol=2e-2)      # the bf16 tier
B, S = 2, 32


def _cfgs(dtype="float32"):
    return (j_get("qwen2-1.5b", smoke=True).replace(dtype=dtype),
            get("qwen2-1.5b", smoke=True).replace(dtype=dtype))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_layout(tree):
    """A reference (stage) tree as nested dicts of numpy arrays with
    ``groups`` unstacked into a list, the port's layout."""
    out = {}
    for k, v in tree.items():
        if k == "groups":
            n = len(jax.tree_util.tree_leaves(v)[0])
            out[k] = [jax.tree_util.tree_map(lambda a, g=g: np.asarray(a[g]),
                                             v) for g in range(n)]
        else:
            out[k] = jax.tree_util.tree_map(np.asarray, v)
    return out


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict/list tree (port or port-layout)."""
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


def _assert_trees(policy, ref_tree, port_tree):
    ref, got = _flat(_port_layout(ref_tree)), _flat(port_tree)
    assert sorted(ref) == sorted(got)
    for k in ref:
        v = policy.compare(ref[k], got[k])
        assert v.ok, f"{k}: {v.detail}"


def _assert_params(ref_tree, port_tree, lr, steps, rtol=1e-5, atol=1e-6,
                   frac=1e-2, bound_only=()):
    """Params after ``steps`` AdamW steps at ``lr`` (see the module doc);
    ``frac``: the share of a leaf's elements that may leave the tier;
    ``bound_only``: leaves held to the 2 lr bound alone, as the key bias
    is (a caller holds them at the tier elsewhere)."""
    ref, got = _flat(_port_layout(ref_tree)), _flat(port_tree)
    assert sorted(ref) == sorted(got)
    bound = 2 * lr * steps
    for k in ref:
        err = np.abs(ref[k] - got[k])
        assert err.max() <= bound, f"{k}: max|err| {err.max()} > {bound}"
        if k.endswith("attn/wk/b") or k in bound_only:
            continue
        off = err > atol + rtol * np.abs(ref[k])
        assert off.sum() <= frac * off.size, \
            f"{k}: {off.sum()} of {off.size} elements off the tier"


def _act(ref):
    """The fp32 tier's rtol, atol 1e-5 of the largest magnitude."""
    return Allclose(rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def setup():
    """fp32 smoke configs, the reference's params in both layouts, one SIL,
    and four numpy batches of (B, S) tokens."""
    jcfg, tcfg = _cfgs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, _np_tree(jparams), device="cpu")
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    stream = TD.synthetic_token_stream(8000, jcfg.vocab_size, seed=0)
    it = TD.lm_batches(stream, B, S, seed=0)
    batches = [next(it) for _ in range(4)]
    return jcfg, tcfg, jparams, tparams, sil, batches


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


# -- data/lm ------------------------------------------------------------------

def test_lm_data_is_bit_identical():
    for vocab, seed in ((512, 0), (100, 1), (151936, 2)):
        want = JD.synthetic_token_stream(5000, vocab, seed=seed)
        got = TD.synthetic_token_stream(5000, vocab, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    stream = TD.synthetic_token_stream(6000, 512, seed=0)
    ji, ti = JD.lm_batches(stream, 4, 32, seed=5), \
        TD.lm_batches(stream, 4, 32, seed=5)
    for _ in range(3):
        a, b = next(ji), next(ti)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    for step in (0, 7, 1000):
        a = JD.lm_batch_at(stream, 4, 32, step, seed=2)
        b = TD.lm_batch_at(stream, 4, 32, step, seed=2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# -- core/partition -----------------------------------------------------------

@pytest.mark.parametrize("arch,n", [("qwen2-1.5b", 1), ("qwen2-1.5b", 2),
                                    ("jamba-1.5-large-398b", 2)])
def test_make_plan_matches_reference(arch, n):
    jcfg, tcfg = j_get(arch, smoke=True), get(arch, smoke=True)
    want = JP.make_plan(jcfg, n)
    got = TP.make_plan(tcfg, n)
    assert (got.n_stages, got.bounds, got.cuts) == \
        (want.n_stages, want.bounds, want.cuts)
    got = TP.make_plan(tcfg, n, strategy="auto")
    want = JP.make_plan(jcfg, n, strategy="auto")
    assert (got.n_stages, got.bounds) == (want.n_stages, want.bounds)
    with pytest.raises(ValueError):
        TP.make_plan(tcfg, 99)


def test_tied_unembed_is_frozen_and_join_keeps_stage0(setup):
    """The port's counterpart of tests/test_train_api.py's: slicing, the
    frozen snapshot (no gradient), the exact join round trip, and a refresh
    that copies."""
    jcfg, cfg, jparams, params, _, batches = setup
    plan = TP.make_plan(cfg, 2)
    sp = [TP.slice_stage_params(cfg, plan, params, k) for k in (0, 1)]
    jsp = [JP.slice_stage_params(jcfg, JP.make_plan(jcfg, 2), jparams, k)
           for k in (0, 1)]
    for k in (0, 1):
        assert sorted(sp[k]) == sorted(jsp[k])
        _assert_trees(Allclose(rtol=0, atol=0), jsp[k], sp[k])
    assert "tied_unembed" in sp[1] and "tok_embed" not in sp[1]
    # the round trip is exact (the same tensors)
    joined = TP.join_stage_params(cfg, plan, sp)
    _assert_same(joined, params)
    # gradients do not flow into the snapshot
    p1 = tree_map(lambda t: t.detach().clone().requires_grad_(), sp[1])
    h = torch.randn(B, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    out, _ = TP.stage_forward(cfg, plan, 1, p1, h, remat=False)
    TL.cross_entropy(out, _tbatch(batches[0])["labels"][:, :16]).backward()
    assert p1["tied_unembed"].grad is None
    assert p1["final_norm"]["scale"].grad.abs().max() > 0
    # join keeps stage 0's (trained) embedding, not the stale snapshot
    sp[0] = dict(sp[0], tok_embed=sp[0]["tok_embed"] + 1.0)
    joined = TP.join_stage_params(cfg, plan, sp)
    assert torch.equal(joined["tok_embed"], sp[0]["tok_embed"])
    assert "tied_unembed" not in joined
    # refresh copies: an in-place update of stage 0 leaves the snapshot
    TP.refresh_tied_unembed(cfg, plan, sp)
    assert torch.equal(sp[1]["tied_unembed"], sp[0]["tok_embed"])
    assert sp[1]["tied_unembed"].data_ptr() != sp[0]["tok_embed"].data_ptr()
    before = sp[1]["tied_unembed"].clone()
    sp[0]["tok_embed"].add_(1.0)
    assert torch.equal(sp[1]["tied_unembed"], before)


@pytest.mark.parametrize("k", [0, 1])
def test_stage_forward_matches_reference(setup, k):
    jcfg, cfg, jparams, params, _, batches = setup
    jplan, plan = JP.make_plan(jcfg, 2), TP.make_plan(cfg, 2)
    jsp = JP.slice_stage_params(jcfg, jplan, jparams, k)
    sp = TP.slice_stage_params(cfg, plan, params, k)
    if k == 0:
        jin, tin = _jbatch(batches[0]), _tbatch(batches[0])
    else:
        h = np.random.RandomState(0).randn(B, S, cfg.d_model) \
            .astype(np.float32)
        jin, tin = jnp.asarray(h), torch.from_numpy(h)
    want, _ = JP.stage_forward(jcfg, jplan, k, jsp, jin)
    got, _ = TP.stage_forward(cfg, plan, k, sp, tin)
    v = _act(want).compare(_f32(want), got.numpy())
    assert v.ok, v.detail
    # the whole network through forward() as well
    want, _ = JM.forward(jcfg, jparams, _jbatch(batches[1]))
    got, _ = TM.forward(cfg, params, _tbatch(batches[1]))
    v = _act(want).compare(_f32(want), got.numpy())
    assert v.ok, v.detail


def test_remat_gives_the_same_gradients(setup):
    """The checkpointed groups recompute to the same gradients."""
    _, cfg, _, params, _, batches = setup
    grads = []
    for remat in (False, True):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        logits, _ = TM.forward(cfg, p, _tbatch(batches[0]), remat=remat)
        TL.cross_entropy(logits, _tbatch(batches[0])["labels"]).backward()
        grads.append([t.grad for t in _flat_leaves(p)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _flat_leaves(tree):
    from repro_torch.tree import tree_leaves
    return list(tree_leaves(tree))


# -- optimizers ---------------------------------------------------------------

_OPT_SHAPES = {"w": (40, 36), "b": (36,), "stack": (2, 33, 48), "n": (5, 3)}


def _opt_case(name):
    if name == "adamw":
        return (JO.adamw(1e-2, weight_decay=0.1),
                TO.adamw(1e-2, weight_decay=0.1), np.float32)
    if name == "adafactor":
        return JO.adafactor(1e-2), TO.adafactor(1e-2), np.float32
    # fp16 params: fp32 masters, dynamic scale, a non-finite step skipped
    kw = dict(loss_scale=8.0, dynamic=True, growth_interval=2)
    return (JO.mixed_precision(JO.adamw(1e-2), **kw),
            TO.mixed_precision(TO.adamw(1e-2), **kw), np.float16)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "mixed_precision"])
def test_optimizer_matches_reference(name):
    jopt, topt, dtype = _opt_case(name)
    rng = np.random.RandomState(0)
    p0 = {k: rng.randn(*s).astype(dtype) for k, s in _OPT_SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jopt.init(jp), topt.init(tp)
    for i in range(6):
        g = {k: (rng.randn(*s) * 4).astype(np.float32)
             for k, s in _OPT_SHAPES.items()}
        if name == "mixed_precision" and i == 2:
            g["b"][3] = np.inf                   # skipped, scale halves
        jp, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        got, tst = topt.update([torch.from_numpy(g[k]) for k in tp], tst, tp)
        assert got is tp                         # updated in place
    # fp16 params round masters that agree at the fp32 tier: the fp16 tier
    policy = FP32 if dtype == np.float32 else Allclose(rtol=1e-2, atol=1e-3)
    for k in p0:
        v = policy.compare(np.asarray(jp[k], np.float32),
                           tp[k].float().numpy())
        assert v.ok, f"{k}: {v.detail}"
        assert tp[k].dtype == torch.from_numpy(p0[k]).dtype
    if name == "mixed_precision":
        assert float(tst["loss_scale"]) == float(jst["loss_scale"])
        assert int(tst["skipped"]) == int(jst["skipped"]) == 1
        for k, m in zip(tp, tst["master"]):
            v = FP32.compare(np.asarray(jst["master"][k]), m.numpy())
            assert v.ok, f"master {k}: {v.detail}"
    else:
        assert int(tst["count"]) == int(jst["count"]) == 6


def test_make_optimizer_resolves_every_name():
    for name in ("sgdm", "adamw", "adafactor"):
        assert TO.make_optimizer(name, 1e-3).name == name


# -- one step of each builder ---------------------------------------------------

def _spec(steps=1, precision="fp32", recovery=0, lr=1e-3):
    kw = dict(n_stages=2, kappa=1.0, precision=precision,
              stages=tuple(StageSpec(steps=steps, lr=lr, optimizer="adamw")
                           for _ in range(2)),
              recovery=StageSpec(steps=recovery, lr=lr / 10,
                                 optimizer="adamw") if recovery else None)
    jkw = dict(kw, stages=tuple(JStageSpec(steps=steps, lr=lr,
                                           optimizer="adamw")
                                for _ in range(2)),
               recovery=JStageSpec(steps=recovery, lr=lr / 10,
                                   optimizer="adamw") if recovery else None)
    return JTrainSpec(**jkw), TrainSpec(**kw)


def _backends(setup, jspec, tspec):
    jcfg, cfg, _, _, _, batches = setup
    jbe = JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                     lambda i: _jbatch(batches[i % 4]), jspec)
    tbe = LMBackend(cfg, TP.make_plan(cfg, 2), lambda i: batches[i % 4],
                    tspec, device="cpu")
    return jbe, tbe


@pytest.mark.parametrize("k", [0, 1])
def test_stage_step_matches_reference(setup, k):
    """Stage 0 against its SIL (the SIL-MSE path), stage 1 with CE through
    the frozen tied unembedding, on the same boundary input."""
    jcfg, cfg, jparams, params, sil, batches = setup
    jspec, tspec = _spec()
    jbe, tbe = _backends(setup, jspec, tspec)
    jsp, tsp = jbe.split(jparams), tbe.split(params)
    if k == 1:
        tbe.before_stage_train(tsp, 1)
        jbe.before_stage_train(jsp, 1)
    jopt, topt = JO.adamw(1e-3), TO.adamw(1e-3)
    jsil = None if k else jnp.asarray(sil)
    tsil = None if k else sil_from_numpy(sil, device="cpu")
    jstep = jbe.build_stage_step(k, jopt, jsil, jsp[k])
    tstep = tbe.build_stage_step(k, topt, tsil)
    b = batches[0]
    if k == 0:
        jin, tin = _jbatch(b), tbe.batch_fn(0)
    else:
        h = np.random.RandomState(1).randn(B, S, cfg.d_model) \
            .astype(np.float32)
        jin, tin = jnp.asarray(h), torch.from_numpy(h)
    jnew, _, jloss = jstep(jsp[k], jopt.init(jbe.trainable(jsp[k])), jin,
                           jnp.asarray(b["labels"]))
    tnew, tst, tloss = tstep(tsp[k], topt.init(tbe.trainable(tsp[k])), tin,
                             torch.from_numpy(b["labels"]).long())
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)
    assert "tied_unembed" not in tbe.trainable(tnew)
    assert len(tst["m"]) == len(_flat(tbe.trainable(tnew)))


def test_recovery_and_baseline_steps_match_reference(setup):
    jcfg, cfg, jparams, params, _, batches = setup
    jspec, tspec = _spec()
    jbe, tbe = _backends(setup, jspec, tspec)
    jsp, tsp = jbe.split(jparams), tbe.split(params)
    jbe.before_stage_train(jsp, 1)
    tbe.before_stage_train(tsp, 1)
    jopt, topt = JO.adamw(1e-3), TO.adamw(1e-3)
    jstep = jbe.build_recovery_step(0, list(jsp), jopt)
    tstep = tbe.build_recovery_step(0, list(tsp), topt)
    jnew, _, jloss = jstep(jsp[0], jopt.init(jsp[0]), _jbatch(batches[1]))
    tnew, _, tloss = tstep(tsp[0], topt.init(tsp[0]), tbe.batch_fn(1))
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)
    # the baseline step trains the joined, unpartitioned tree
    jstep = jbe.build_baseline_step(jopt)
    tstep = tbe.build_baseline_step(topt)
    jtree = jax.tree_util.tree_map(jnp.copy, jparams)
    ttree = tree_map(lambda t: t.clone(), params)
    jnew, _, jloss = jstep(jtree, jopt.init(jtree), _jbatch(batches[2]))
    tnew, _, tloss = tstep(ttree, topt.init(ttree), tbe.batch_fn(2))
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)


# -- the whole schedule ---------------------------------------------------------

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_run_lm_sequential_matches_reference(setup, precision):
    """2 stages + recovery, 3 steps each, the reference's SIL passed across:
    per-step losses at the precision's tier, the same (phase, stage, step)
    records, and a joined model whose every leaf agrees."""
    jcfg, cfg, jparams, params, sil, batches = setup
    jspec, tspec = _spec(steps=3, precision=precision, recovery=3)
    jplan, plan = JP.make_plan(jcfg, 2), TP.make_plan(cfg, 2)
    key = jax.random.PRNGKey(1)
    jsil = JS.make_sil(jax.random.split(key, 2)[0], jcfg.d_model,
                       jcfg.vocab_size, 1.0)
    jjoined, jhist = JTrainer(
        JLMBackend(jcfg, jplan, lambda i: _jbatch(batches[i % 4]), jspec),
        jspec).run(JRc.lm_sequential_phases(2), params=jparams, sils=[jsil])
    tjoined, thist = recipes.run_lm_sequential(
        cfg, plan, params, lambda i: batches[i % 4], tspec,
        sils=[sil_from_numpy(np.asarray(jsil), device="cpu")], device="cpu")
    policy = FP32 if precision == "fp32" else BF16
    for col in ("phase", "stage", "step"):
        assert thist.column(col) == jhist.column(col)
    assert len(thist.column("loss")) == 3 + 3 + 3
    v = policy.compare(_f32(jhist.column("loss")),
                       _f32(thist.column("loss")))
    assert v.ok, v.detail
    if precision == "fp32":
        _assert_params(jjoined, tjoined, 1e-3, 6)   # stage 0: 3 + 3 steps
    else:
        _assert_trees(policy, jjoined, tjoined)
    # the caller's params are untouched (the backend trains its own copies)
    _assert_same(params, params_from_numpy(cfg, _np_tree(jparams),
                                           device="cpu"))


def test_tied_sequential_training_still_learns(setup):
    """The port's counterpart of tests/test_train_api.py's: every stage
    trains, the joined model is finite and keeps stage 0's embedding."""
    _, cfg, _, params, _, batches = setup
    spec = TrainSpec(n_stages=2, kappa=1.0, stages=(
        StageSpec(steps=4, lr=2e-3, optimizer="adamw"),) * 2)
    joined, hist = recipes.run_lm_sequential(
        cfg, 2, params, lambda i: batches[i % 4], spec,
        torch.Generator().manual_seed(1), device="cpu")
    recs = [(r.stage, r.loss) for r in hist.records if r.loss is not None]
    s0 = [v for s, v in recs if s == 0]
    s1 = [v for s, v in recs if s == 1]
    assert len(s0) == len(s1) == 4
    assert s0[-1] < s0[0] and s1[-1] < s1[0]
    logits, _ = TM.forward(cfg, joined, _tbatch(batches[0]))
    assert torch.isfinite(logits).all()
    assert (joined["tok_embed"] - params["tok_embed"]).abs().max() > 0


def test_lm_baseline_phase_trains_tied_unpartitioned(setup):
    """The port's counterpart of tests/test_train_api.py's: BaselinePhase on
    a tied LM is unpartitioned training (the tied embedding gets the
    unembedding's gradient), and it matches the reference's per step."""
    jcfg, cfg, jparams, params, _, batches = setup
    jspec = JTrainSpec(n_stages=2, baseline=JStageSpec(steps=6, lr=1e-3,
                                                      optimizer="adamw"))
    tspec = TrainSpec(n_stages=2, baseline=StageSpec(steps=6, lr=1e-3,
                                                     optimizer="adamw"))
    jbe, tbe = _backends(setup, jspec, tspec)
    _, jhist = JTrainer(jbe, jspec).run([JBaselinePhase()], params=jparams)
    joined, hist = Trainer(tbe, tspec).run([BaselinePhase()], params=params)
    ls = hist.column("loss")
    assert ls[-1] < ls[0]
    assert (joined["tok_embed"] - params["tok_embed"]).abs().max() > 0
    v = FP32.compare(_f32(jhist.column("loss")), _f32(ls))
    assert v.ok, v.detail


# -- the launcher ---------------------------------------------------------------

def test_launch_train_pnn_smoke_on_cpu(capsys):
    _, hist = launch_train.main(["--arch", "qwen2-1.5b", "--smoke",
                                 "--mode", "pnn", "--stages", "2",
                                 "--device", "cpu"])
    # the reference's spec: 20 // 2 steps a stage, 20 // 4 of recovery
    phases = hist.column("phase")
    assert [phases.count(p) for p in ("left", "right", "recovery")] == \
        [10, 10, 5]
    assert all(np.isfinite(hist.column("loss")))
    assert "PNN losses (tail)" in capsys.readouterr().out


@pytest.mark.parametrize("argv,err", [
    # the unpartitioned train step of launch/steps.py is ported
    (["--mode", "baseline", "--arch", "qwen2-1.5b", "--steps", "4",
      "--batch", "2", "--seq", "16"], None),
    # the searched cut is ported: it trains on the reference's bounds
    (["--mode", "pnn", "--stages", "auto", "--steps", "4", "--batch", "2",
      "--seq", "16"], None),
    # stage placement is ported; it exists only for partitioned training
    (["--mode", "baseline", "--dist", "round_robin"], SystemExit),
    # checkpoints are ported; a directory without any cannot resume
    (["--mode", "pnn", "--resume", "no-such-ckpts"], FileNotFoundError),
    (["--mode", "pnn", "--seq-shard"], SystemExit),
    # the paper MLP's Fig. 5 is ported, on its searched cut too
    (["--arch", "paper_mlp", "--mode", "pnn", "--stages", "auto",
      "--steps", "1"], None),
], ids=["lm-baseline", "auto", "dist", "resume", "seq-shard", "mlp-pnn"])
def test_launch_train_refuses_what_is_not_ported(argv, err, capsys):
    """What is not ported raises; ``--mode baseline`` (``err`` None) logs a
    finite ``ce`` at each of its 4 steps, and ``--stages auto`` runs on the
    bounds the reference's searcher gives (the smoke qwen2's and the paper
    MLP's, 2 stages)."""
    if err is not None:
        with pytest.raises(err):
            launch_train.main(["--smoke", "--device", "cpu"] + argv)
        return
    launch_train.main(["--smoke", "--device", "cpu"] + argv)
    if "baseline" in argv:
        ces = re.findall(r"^step +\d+ ce=(\S+) grad_norm=(\S+) ",
                         capsys.readouterr().out, re.M)
        assert len(ces) == 4
        assert np.isfinite(np.asarray(ces, np.float64)).all()
        return
    if "paper_mlp" in argv:
        bounds = JPlan.auto_mlp_bounds(JMLPConfig(sizes=(784, 32, 16, 16, 47),
                                                  cut=2), 2)
        want = f"plan[auto]: 2 stages, bounds {bounds}"
    else:
        bounds = JP.make_plan(j_get("qwen2-1.5b", smoke=True), 2,
                              strategy="auto").bounds
        want = f"plan[auto]: 2 stages, searched bounds {bounds}"
    assert want in capsys.readouterr().out


def test_launch_train_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2-1.5b", "--smoke", "--mode",
                           "pnn"])
