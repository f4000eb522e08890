"""Stage-by-stage training of a mixture-of-experts LM in the port against
``repro``, on granite-moe-3b-a800m's smoke config (2 layers, d 256, 4/2
heads of 64, 4 experts of d_ff 128, top 2, tied) on the CPU.

The objective carries the switch load-balance and router z-losses: the last
stage's CE and every interior stage's SIL-MSE add
``load_balance_loss * lb + router_z_loss * z`` of the stage's own MoE
layers; §5 recovery adds the last stage's only, as the reference does.
Params and SIL tables come from the reference through
``repro_torch.convert``; the token data is numpy in both packages.  Losses
and the aux terms at the fp32 tier (rtol 1e-5, atol 1e-6), or the bf16 tier
(2e-2) under a bf16 policy; params after fp32 AdamW steps as
``test_torch_lm_train._assert_params`` holds them (all but 1% of a leaf at
the tier, the rest within 2 lr a step).  Within torch the
MoE backward is deterministic: two runs give the same gradients, bit for
bit, and the Fig.-3 cache step equals the live one bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.core import losses as JLoss
from repro.core import partition as JP
from repro.core import sil as JS
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro.train import LMBackend as JLMBackend
from repro.train import Trainer as JTrainer
from repro.train import recipes as JRc
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy, sil_from_numpy
from repro_torch.core import losses as TLoss
from repro_torch.core import partition as TP
from repro_torch.data import lm as TD
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO
from repro_torch.train import (BoundaryMaterializePhase, FrozenPrefixPhase,
                               LMBackend, SilStagePhase, Trainer, recipes)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.verify.compare import Allclose

from test_torch_lm_train import (_assert_params, _assert_trees, _f32,
                                 _np_tree, _spec)

ARCH = "granite-moe-3b-a800m"
FP32 = Allclose()                          # rtol 1e-5, atol 1e-6
BF16 = Allclose(rtol=2e-2, atol=2e-2)
B, S = 2, 32


@pytest.fixture(scope="module")
def setup():
    """fp32 smoke configs, the reference's params in both layouts, one SIL,
    and four numpy batches of (B, S) tokens."""
    jcfg = j_get(ARCH, smoke=True).replace(dtype="float32")
    cfg = get(ARCH, smoke=True).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jparams), device="cpu")
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    stream = TD.synthetic_token_stream(8000, jcfg.vocab_size, seed=0)
    it = TD.lm_batches(stream, B, S, seed=0)
    batches = [next(it) for _ in range(4)]
    return jcfg, cfg, jparams, params, sil, batches


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


def _backends(setup, jspec, tspec):
    jcfg, cfg, _, _, _, batches = setup
    jbe = JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                     lambda i: _jbatch(batches[i % 4]), jspec)
    tbe = LMBackend(cfg, TP.make_plan(cfg, 2), lambda i: batches[i % 4],
                    tspec, device="cpu")
    return jbe, tbe


def test_train_objective_adds_the_aux_terms(setup):
    """CE + 1e-2 lb + 1e-3 z with metrics ce, lb, z and loss, as the
    reference's, on the forward of the whole network."""
    jcfg, cfg, jparams, params, _, batches = setup
    jl, jaux = JM.forward(jcfg, jparams, _jbatch(batches[0]))
    tl, taux = TM.forward(cfg, params, _tbatch(batches[0]))
    labels = batches[0]["labels"]
    jloss, jm = JLoss.train_objective(jcfg, jl, jnp.asarray(labels), jaux)
    tloss, tm = TLoss.train_objective(cfg, tl, _tbatch(batches[0])["labels"],
                                      taux)
    assert sorted(tm) == sorted(jm) == ["ce", "lb", "loss", "z"]
    for k in jm:
        v = FP32.compare(_f32(jm[k]), tm[k].detach().numpy())
        assert v.ok, f"{k}: {v.detail}"
    want = tm["ce"] + cfg.moe.load_balance_loss * taux["lb_loss"] \
        + cfg.moe.router_z_loss * taux["z_loss"]
    assert torch.equal(tloss, want) and tloss is tm["loss"]
    assert tm["loss"] > tm["ce"]


@pytest.mark.parametrize("k", [0, 1])
def test_stage_step_matches_reference(setup, k):
    """Stage 0 on SIL-MSE + its aux terms, stage 1 on CE + its own aux
    through the frozen tied unembedding, on the same boundary input."""
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
    b = batches[0]
    if k == 0:
        jin, tin = _jbatch(b), tbe.batch_fn(0)
    else:
        h = np.random.RandomState(1).randn(B, S, cfg.d_model) \
            .astype(np.float32)
        jin, tin = jnp.asarray(h), torch.from_numpy(h)
    labels = torch.from_numpy(b["labels"]).long()
    # the aux terms are in the loss: it exceeds the plain SIL-MSE / CE
    p = tbe.trainable(tsp[k])
    frozen = {n: v for n, v in tsp[k].items() if n not in p}
    with torch.no_grad():
        full = tbe.stage_loss(k, tsil, frozen)(p, tin, labels, None)
        out, aux = TP.stage_forward(cfg, tbe.plan, k, tsp[k], tin)
    plain = TLoss.sil_stage_loss(out, tsil, labels) if k == 0 else \
        TLoss.cross_entropy(out, labels, vocab_size=cfg.vocab_size)
    assert torch.equal(full, plain + cfg.moe.load_balance_loss
                       * aux["lb_loss"] + cfg.moe.router_z_loss
                       * aux["z_loss"])
    jstep = jbe.build_stage_step(k, jopt, jsil, jsp[k])
    tstep = tbe.build_stage_step(k, topt, tsil)
    jnew, _, jloss = jstep(jsp[k], jopt.init(jbe.trainable(jsp[k])), jin,
                           jnp.asarray(b["labels"]))
    tnew, _, tloss = tstep(tsp[k], topt.init(tbe.trainable(tsp[k])), tin,
                           labels)
    assert float(tloss) == float(full)
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)


def test_recovery_step_matches_reference(setup):
    """Only the last stage's aux terms reach the recovery objective, as in
    the reference (its loop keeps the last ``stage_forward``'s aux)."""
    jcfg, cfg, jparams, params, _, batches = setup
    jspec, tspec = _spec()
    jbe, tbe = _backends(setup, jspec, tspec)
    jsp, tsp = jbe.split(jparams), tbe.split(params)
    jbe.before_stage_train(jsp, 1)
    tbe.before_stage_train(tsp, 1)
    batch = tbe.batch_fn(1)
    with torch.no_grad():
        h, aux0 = TP.stage_forward(cfg, tbe.plan, 0, tsp[0], batch)
        logits, aux1 = TP.stage_forward(cfg, tbe.plan, 1, tsp[1], h)
        want = TLoss.train_objective(cfg, logits, batch["labels"], aux1)[0]
        got = tbe.recovery_loss(0, list(tsp), {})(tsp[0], batch)
    assert torch.equal(got, want) and float(aux0["lb_loss"]) > 0
    jopt, topt = JO.adamw(1e-3), TO.adamw(1e-3)
    jstep = jbe.build_recovery_step(0, list(jsp), jopt)
    tstep = tbe.build_recovery_step(0, list(tsp), topt)
    jnew, _, jloss = jstep(jsp[0], jopt.init(jsp[0]), _jbatch(batches[1]))
    tnew, _, tloss = tstep(tsp[0], topt.init(tsp[0]), batch)
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_run_lm_sequential_matches_reference(setup, precision):
    """2 stages + recovery, 3 steps each: per-step losses at the
    precision's tier, the same records, the joined params, and the trained
    network's objective with its lb and z."""
    jcfg, cfg, jparams, params, _, batches = setup
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
    v = policy.compare(_f32(jhist.column("loss")), _f32(thist.column("loss")))
    assert v.ok, v.detail
    if precision == "fp32":
        _assert_params(jjoined, tjoined, 1e-3, 6)   # stage 0: 3 + 3 steps
    else:
        _assert_trees(policy, jjoined, tjoined)
    # the trained network's objective and its aux metrics
    b = batches[3]
    jl, jaux = JM.forward(jcfg, jjoined, _jbatch(b))
    with torch.no_grad():
        tl, taux = TM.forward(cfg, tjoined, _tbatch(b))
    _, jm = JLoss.train_objective(jcfg, jl, jnp.asarray(b["labels"]), jaux)
    _, tm = TLoss.train_objective(cfg, tl, _tbatch(b)["labels"], taux)
    for k in ("lb", "z", "loss"):
        v = policy.compare(_f32(jm[k]), tm[k].numpy())
        assert v.ok, f"{k}: {v.detail}"


def _grads(cfg, params, batch):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    logits, aux = TM.forward(cfg, p, batch)
    TLoss.train_objective(cfg, logits, batch["labels"], aux)[0].backward()
    return [t.grad for t in tree_leaves(p)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_backward_is_bitwise_repeatable(setup, dtype):
    """Two backward passes of the whole network (rematerialized groups, two
    dispatch groups of 32 tokens with 8 slots an expert, so picks drop)
    give the same gradients bit for bit."""
    _, cfg, _, params, _, batches = setup
    cfg = cfg.replace(dtype=dtype, moe_dispatch_groups=2,
                      moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    assert TL.moe_capacity(B * S // 2, cfg.moe) == 8
    batch = _tbatch(batches[0])
    a, b = _grads(cfg, params, batch), _grads(cfg, params, batch)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(x is not None for x in a)


def test_fig5_matches_reference(setup):
    """Both stages at once through the stage executor (Fig. 5): every
    (step, stage) loss at the fp32 tier and the joined params."""
    jcfg, cfg, jparams, params, _, batches = setup
    jspec, tspec = _spec(steps=3)
    key = jax.random.PRNGKey(1)
    jjoined, jh = JRc.run_lm_parallel(
        jcfg, 2, jparams, lambda i: _jbatch(batches[i % 4]), jspec, key)
    sil = sil_from_numpy(np.asarray(JS.make_sil(
        jax.random.split(key, 2)[0], jcfg.d_model, jcfg.vocab_size, 1.0)),
        device="cpu")
    joined, th = recipes.run_lm_parallel(
        cfg, 2, params, lambda i: batches[i % 4], tspec,
        sils=[sil.t().contiguous().t()], dist="round_robin",
        dist_devices=[torch.device("cpu")] * 2, device="cpu")
    assert [(r.step, r.stage) for r in th.records] == \
        [(r.step, r.stage) for r in jh.records]
    v = FP32.compare(_f32(jh.column("loss")), _f32(th.column("loss")))
    assert v.ok, v.detail
    _assert_params(jjoined, joined, 1e-3, 3)


def test_fig3_cache_step_equals_live_bitwise(setup):
    """The right phase on the stored boundary is the live one, bit for bit,
    with the MoE aux terms of stage 1 in both."""
    _, cfg, _, params, sil, batches = setup
    _, tspec = _spec(steps=2)
    runs = []
    for phases in ([SilStagePhase(stage=0),
                    BoundaryMaterializePhase(upto=1, n_batches=2),
                    FrozenPrefixPhase(stage=1, source="cache")],
                   [SilStagePhase(stage=0),
                    FrozenPrefixPhase(stage=1, source="live")]):
        be = LMBackend(cfg, TP.make_plan(cfg, 2), lambda i: batches[i % 4],
                       tspec, device="cpu")
        runs.append(Trainer(be, tspec).run(
            phases, params=tree_map(torch.clone, params),
            sils=[sil_from_numpy(sil, device="cpu")]))
    (cached, hc), (live, hl) = runs
    assert hc.column("loss") == hl.column("loss")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cached),
                                                 tree_leaves(live)))


def test_launch_train_pnn_granite_smoke_on_cpu(capsys):
    _, hist = launch_train.main(["--arch", ARCH, "--smoke", "--mode", "pnn",
                                 "--stages", "2", "--device", "cpu",
                                 "--steps", "4", "--batch", "2",
                                 "--seq", "16"])
    assert all(np.isfinite(hist.column("loss")))
    assert "PNN losses (tail)" in capsys.readouterr().out
