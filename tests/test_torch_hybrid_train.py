"""Stage-by-stage training of Jamba's hybrid Mamba stack in the port against
``repro``, on the CPU, on two smoke cuts of ``jamba-1.5-large-398b``:

* ``experts``: the smoke config itself (4 layers, d 256, d_inner 512, N 16,
  4/2 heads of 64, 4 experts of d_ff 512 top 2 every other layer,
  ``attn_period`` 2, untied): 2 groups of (Mamba + MoE, attention + dense),
  one a stage, so each stage objective carries its MoE aux terms;
* ``attention_free``: ``smoke().replace(n_layers=2, attn_period=8,
  moe=None)``, the card's train cut at smoke widths: 2 groups of one Mamba
  layer with a dense SwiGLU, one a stage, no attention layer anywhere.

Params and SIL tables come from the reference through
``repro_torch.convert``; the token data is numpy in both packages.  Each
stage's step (SIL-MSE + aux on stage 0, CE + aux through the untied
unembedding on stage 1), the recovery step, ``run_lm_sequential`` and Fig.
5 (``run_lm_parallel``) are held at the tolerances of
``test_torch_lm_train.py``, fp32: losses at the fp32 tier (rtol 1e-5, atol
1e-6), params after AdamW steps as
``_assert_params`` holds them (all but 1% of a leaf at the tier, the rest
within 2 lr a step).  A step from the same params is held at the fp32
tier; the losses of a multi-step schedule (``run_lm_sequential``, Fig. 5)
are held at ``SCHEDULE`` (rtol 1e-3), since the reference's own losses
leave the fp32 tier when its params move by 1e-7 of themselves
(``test_reference_schedule_leaves_the_fp32_tier_on_its_own``: AdamW's
first steps move an element by ~lr whatever its gradient's size, so
gradients near zero carry a rounding-level input change into the params;
with experts, a near-tie route flips too).  Measured on the CPU: the
reference perturbed so moved by up to 2.3e-5 of a loss (attention-free)
and 2.7e-4 (experts), the port by up to 1.5e-5 and 2.8e-4.  The joined
params after a schedule are held as ``_assert_params`` holds them, but
with ``SCHEDULE_FRAC`` of a leaf allowed off the tier: 1% on the
attention-free cut; 3/4 with experts, where the reference perturbed by
1e-7 leaves up to 54% of a stage-1 leaf off it (a route flips; measured by
``test_reference_schedule_leaves_the_fp32_tier_on_its_own`` on each cut,
which holds the reference's own share under ``SCHEDULE_FRAC``) and the
port up to 60% (stage 1's ``conv_b``).  On the CPU every Mamba layer's
scan is the plain version under autograd; its CUDA backward is held against the plain one in
tests/test_torch_scan_bwd.py and on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.core import partition as JP
from repro.core import sil as JS
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro.train import LMBackend as JLMBackend
from repro.train import Trainer as JTrainer
from repro.train import recipes as JRc
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy, sil_from_numpy
from repro_torch.core import partition as TP
from repro_torch.data import lm as TD
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO
from repro_torch.train import LMBackend, recipes
from repro_torch.verify.compare import Allclose

from test_torch_lm_train import (_assert_params, _f32, _flat, _np_tree,
                                 _port_layout, _spec)
from _torch_threads import _one_thread  # noqa: F401

ARCH = "jamba-1.5-large-398b"
FP32 = Allclose()                          # rtol 1e-5, atol 1e-6
SCHEDULE = Allclose(rtol=1e-3, atol=1e-6)  # losses after AdamW steps
B, S = 2, 32
CUTS = {"experts": {},
        "attention_free": dict(n_layers=2, attn_period=8, moe=None)}
# the share of a joined leaf that may leave the fp32 tier after a schedule,
# by whether the cut has experts (see the module doc)
SCHEDULE_FRAC = {False: 1e-2, True: 0.75}


@pytest.fixture(scope="module", params=sorted(CUTS))
def setup(request):
    """fp32 configs of one cut, the reference's params in both layouts, one
    SIL, and four numpy batches of (B, S) tokens."""
    cut = CUTS[request.param]
    jcfg = j_get(ARCH, smoke=True).replace(dtype="float32", **cut)
    cfg = get(ARCH, smoke=True).replace(dtype="float32", **cut)
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


def _backends(setup, jspec, tspec):
    jcfg, cfg, _, _, _, batches = setup
    jbe = JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                     lambda i: _jbatch(batches[i % 4]), jspec)
    tbe = LMBackend(cfg, TP.make_plan(cfg, 2), lambda i: batches[i % 4],
                    tspec, device="cpu")
    return jbe, tbe


def test_the_cuts(setup):
    """Both cuts split into 2 one-group stages; the attention-free one has
    only Mamba slots and no experts, the other a MoE layer a stage."""
    jcfg, cfg, *_ = setup
    plan = TP.make_plan(cfg, 2)
    assert plan.bounds == JP.make_plan(jcfg, 2).bounds == ((0, 1), (1, 2))
    kinds = [k for k, _, _ in TM.slot_spec(cfg)]
    if cfg.moe is None:
        assert kinds == ["mamba"] and TM.n_groups(cfg) == 2
    else:
        assert kinds == ["mamba", "attn"]
        assert [m for _, m, _ in TM.slot_spec(cfg)] == [True, False]
    assert not cfg.tie_embeddings


@pytest.mark.parametrize("k", [0, 1])
def test_stage_step_matches_reference(setup, k):
    """Stage 0 on SIL-MSE (+ its aux terms), stage 1 on CE (+ its own aux)
    through its trained untied unembedding, on the same boundary input."""
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
    jstep = jbe.build_stage_step(k, jopt, jsil, jsp[k])
    tstep = tbe.build_stage_step(k, topt, tsil)
    jnew, _, jloss = jstep(jsp[k], jopt.init(jbe.trainable(jsp[k])), jin,
                           jnp.asarray(b["labels"]))
    tnew, _, tloss = tstep(tsp[k], topt.init(tbe.trainable(tsp[k])), tin,
                           labels)
    v = FP32.compare(_f32(jloss), tloss.numpy())
    assert v.ok, v.detail
    _assert_params(jnew, tnew, 1e-3, 1)


def test_recovery_step_matches_reference(setup):
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
    v = FP32.compare(_f32(jloss), tloss.numpy())
    assert v.ok, v.detail
    _assert_params(jnew, tnew, 1e-3, 1)


def _jsil():
    key = jax.random.PRNGKey(1)
    return key, JS.make_sil(jax.random.split(key, 2)[0], 256, 512, 1.0)


def _ref_sequential(jcfg, jparams, batches, jspec):
    return JTrainer(
        JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                   lambda i: _jbatch(batches[i % 4]), jspec),
        jspec).run(JRc.lm_sequential_phases(2), params=jparams,
                   sils=[_jsil()[1]])


def test_run_lm_sequential_matches_reference(setup):
    """2 stages + recovery, 3 steps each, fp32: the same records, every
    loss at ``SCHEDULE``'s tier, and the joined params."""
    jcfg, cfg, jparams, params, _, batches = setup
    jspec, tspec = _spec(steps=3, precision="fp32", recovery=3)
    jjoined, jhist = _ref_sequential(jcfg, jparams, batches, jspec)
    tjoined, thist = recipes.run_lm_sequential(
        cfg, TP.make_plan(cfg, 2), params, lambda i: batches[i % 4], tspec,
        sils=[sil_from_numpy(np.asarray(_jsil()[1]), device="cpu")],
        device="cpu")
    for col in ("phase", "stage", "step"):
        assert thist.column(col) == jhist.column(col)
    v = SCHEDULE.compare(_f32(jhist.column("loss")),
                         _f32(thist.column("loss")))
    assert v.ok, v.detail
    # stage 0: 3 + 3 steps
    _assert_params(jjoined, tjoined, 1e-3, 6,
                   frac=SCHEDULE_FRAC[cfg.moe is not None])


@pytest.mark.parametrize("name", sorted(CUTS))
def test_reference_schedule_leaves_the_fp32_tier_on_its_own(name):
    """The reference's own schedule on each cut, from its params and from
    the same params times (1 + 1e-7 noise): some loss moves by more than
    the fp32 tier, so a port run that rounds otherwise cannot be held there
    after AdamW steps; every loss stays within ``SCHEDULE``.  The joined
    params: the largest share of a leaf off the tier stays within
    ``SCHEDULE_FRAC``, and is above 1% only with experts."""
    jcfg = j_get(ARCH, smoke=True).replace(dtype="float32", **CUTS[name])
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    moved = jax.tree.map(lambda x: x * (1 + 1e-7 * rng.standard_normal(
        x.shape)).astype(np.float32), jparams)
    it = TD.lm_batches(TD.synthetic_token_stream(8000, jcfg.vocab_size,
                                                 seed=0), B, S, seed=0)
    batches = [next(it) for _ in range(4)]
    jspec, _ = _spec(steps=3, precision="fp32", recovery=3)
    (pa, ha), (pb, hb) = (_ref_sequential(jcfg, p, batches, jspec)
                          for p in (jparams, moved))
    a, b = _f32(ha.column("loss")), _f32(hb.column("loss"))
    assert not FP32.compare(a, b).ok
    v = SCHEDULE.compare(a, b)
    assert v.ok, v.detail
    fa, fb = (_flat(_port_layout(_np_tree(p))) for p in (pa, pb))
    share = max(float(np.mean(np.abs(fa[k] - fb[k])
                              > 1e-6 + 1e-5 * np.abs(fa[k]))) for k in fa)
    has_experts = jcfg.moe is not None
    assert share <= SCHEDULE_FRAC[has_experts], share
    assert (share > 1e-2) == has_experts, share


def test_fig5_matches_reference(setup):
    """Both stages at once through the stage executor (Fig. 5): every
    (step, stage) loss at the fp32 tier and the joined params."""
    jcfg, cfg, jparams, params, _, batches = setup
    jspec, tspec = _spec(steps=3)
    key = _jsil()[0]
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
    v = SCHEDULE.compare(_f32(jh.column("loss")), _f32(th.column("loss")))
    assert v.ok, v.detail
    _assert_params(jjoined, joined, 1e-3, 3,
                   frac=SCHEDULE_FRAC[cfg.moe is not None])


def test_launch_train_pnn_jamba_smoke_on_cpu(capsys):
    _, hist = launch_train.main(["--arch", ARCH, "--smoke", "--mode", "pnn",
                                 "--device", "cpu", "--steps", "4",
                                 "--batch", "2", "--seq", "16"])
    assert all(np.isfinite(hist.column("loss")))
    assert hist.column("phase") == ["left", "left", "right", "right",
                                    "recovery"]
    assert "PNN losses (tail)" in capsys.readouterr().out
