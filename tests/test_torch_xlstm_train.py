"""Training xlstm-125m's smoke config (tests/test_torch_xlstm.py) in the
port against ``repro`` on the CPU: the whole network's gradients against
``jax.grad``, stage by stage over a 2-stage plan (a group of mLSTM + sLSTM
each; the last stage unembeds with its frozen copy of the tied table), and
the reference's five-step regression (tests/test_archs.py: masking the
mLSTM chunk's decay before its exponential keeps the backward finite).

Params and the SIL table come from the reference through
``repro_torch.convert``; tokens and labels are numpy arrays in both
packages.  Losses at the fp32 tier (rtol 1e-5, atol 1e-6), over S 40
(one chunk) and, for the whole network, S 77 (two chunks, the second
padded).  Gradients at rtol 1e-5 and atol ``GRAD_ATOL`` of each leaf's
largest magnitude: 1e-4, not the 1e-5 of the attention slices.  The
gate biases' and sLSTM's ``r`` and ``w_in`` gradients are sums over every
token and step, with cancellation through the cumulative decay and the
recurrence, which the two packages add in other orders; at 1e-5 the SIL
step, recovery and the whole network miss by up to 4.2x on those leaves.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as JLoss
from repro.core import partition as JP
from repro.core import sil as JS
from repro.models import model as JM
from repro.train import LMBackend as JLMBackend
from repro.train import Trainer as JTrainer
from repro.train import recipes as JRc
from repro_torch.configs import get as tget
from repro_torch.convert import sil_from_numpy
from repro_torch.core import losses as TLoss
from repro_torch.core import partition as TP
from repro_torch.data import lm as TD
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.train import LMBackend, recipes
from repro_torch.train.backends import value_and_accum_grads
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.verify.compare import Allclose

from test_torch_lm_train import _f32, _spec
from test_torch_whisper_train import _paths, _port_layout_flat
from test_torch_xlstm import tokens, world
from _torch_threads import _one_thread  # noqa: F401

FP32 = Allclose()                          # rtol 1e-5, atol 1e-6
GRAD_ATOL = 1e-4
B, S = 2, 40


@functools.lru_cache(maxsize=None)
def setup():
    """The fp32 world, one (d, vocab) SIL table and four numpy batches."""
    jcfg, jparams, tcfg, tparams = world()
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    it = TD.lm_batches(TD.synthetic_token_stream(8000, jcfg.vocab_size,
                                                 seed=0), B, S, seed=0)
    return jcfg, jparams, tcfg, tparams, sil, [next(it) for _ in range(4)]


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _backends(jspec, tspec):
    jcfg, _, tcfg, _, _, batches = setup()
    jbe = JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                     lambda i: _jbatch(batches[i % 4]), jspec)
    tbe = LMBackend(tcfg, TP.make_plan(tcfg, 2), lambda i: batches[i % 4],
                    tspec, device="cpu")
    return jbe, tbe


def _assert_grads(jgrads, tparams, tgrads):
    """Every gradient leaf of the reference's tree (its stacked groups
    unstacked) against the port's, at rtol 1e-5 and ``GRAD_ATOL`` of the
    leaf's largest magnitude."""
    want = _port_layout_flat(jgrads)
    got = dict(zip(_paths(tparams), (g.float().numpy() for g in tgrads)))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        v = Allclose(rtol=1e-5, atol=GRAD_ATOL * max(
            float(np.abs(w).max()), 1e-30)).compare(w, got[k])
        assert v.ok, f"{k}: {v.detail}"


@pytest.mark.parametrize("tie", [False, True], ids=["plain", "tie"])
def test_slstm_backward_through_time_passes_gradcheck(tie):
    """The sLSTM sequence's hand-written backward against finite
    differences in float64 (B 2, S 5, 2 heads of 3), every input's
    gradient: the step inputs, ``r`` and the initial state; with ``tie``
    the first step's stabiliser has f + m == i in one element, where
    ``maximum`` gives each side half the gradient."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64) * 0.5
    xs, r = rand(2, 5, 2, 12), rand(2, 3, 12)
    h0, c0, n0, m0 = rand(2, 6), rand(2, 6), rand(2, 6).abs() + 0.5, \
        rand(2, 6)
    if tie:     # element 0's f + m equals its i at the first step
        rec = torch.einsum("bhd,hde->bhe", h0.view(2, 2, 3), r)
        zifo = (xs[:, 0] + rec).reshape(2, 24)
        m0[0, 0] = zifo[0, 6] - zifo[0, 12]
    args = [t.requires_grad_(True) for t in (xs, r, h0, c0, n0, m0)]
    assert torch.autograd.gradcheck(TL._SLSTMSequence.apply, args,
                                    nondet_tol=0.0)


def test_whole_network_grads_match_jax_grad():
    """CE over (2, 77) tokens through the whole network with ``remat``
    (each group recomputed in the backward): the loss and the gradient of
    every leaf, the tied table's (embedding and unembedding) summed."""
    jcfg, jparams, tcfg, tparams = world()
    tok, lab = tokens(tcfg, B, 77, 1), tokens(tcfg, B, 77, 2)

    def jloss(p):
        logits, aux = JM.forward(jcfg, p, {"tokens": jnp.asarray(tok)})
        return JLoss.train_objective(jcfg, logits, jnp.asarray(lab), aux)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    logits, aux = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                             remat=True)
    tl = TLoss.train_objective(tcfg, logits, torch.from_numpy(lab), aux)[0]
    tl.backward()
    assert FP32.compare(_f32(jl), tl.detach().numpy()).ok
    _assert_grads(jg, tp, [t.grad for t in tree_leaves(tp)])


@pytest.mark.parametrize("step", ["left", "right", "recovery"])
def test_first_step_loss_and_grads_match_reference(step):
    """The three step functions' loss and gradients on the first batch:
    stage 0 against its SIL, stage 1 with CE on the live frozen prefix,
    stage 0 trained through the frozen stage 1."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec()
    jbe, tbe = _backends(jspec, tspec)
    jplan = JP.make_plan(jcfg, 2)
    jsp, tsp = jbe.split(jparams), tbe.split(tparams)
    jb, tb = _jbatch(batches[0]), tbe.batch_fn(0)
    labels = jb["labels"]

    def jstage(k, p, x):
        return JP.stage_forward(jcfg, jplan, k, p, x, remat=False)

    def jce(out):
        logits, aux = out
        return JLoss.train_objective(jcfg, logits, labels, aux, None)[0]
    if step == "left":
        jloss, jg = jax.jit(jax.value_and_grad(lambda p: JLoss.sil_stage_loss(
            jstage(0, p, jb)[0], jnp.asarray(sil), labels)))(jsp[0])
        tloss, tg = value_and_accum_grads(
            tbe.stage_loss(0, sil_from_numpy(sil, device="cpu"), {}),
            tsp[0], (tb, tb["labels"], None))
        trained = tsp[0]
    elif step == "right":
        x = jax.jit(lambda p: jstage(0, p, jb)[0])(jsp[0])
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jce(jstage(1, p, x))))(jsp[1])
        h = tbe.prefix_forward(1)((tsp[0],), tb)
        tloss, tg = value_and_accum_grads(tbe.stage_loss(1, None, {}),
                                          tsp[1], (h, tb["labels"], None))
        trained = tsp[1]
    else:
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jce(jstage(1, jsp[1], jstage(0, p, jb)[0]))))(jsp[0])
        frozen = [tree_map(lambda t: t.detach(), sp) for sp in tsp]
        tloss, tg = value_and_accum_grads(tbe.recovery_loss(0, frozen, {}),
                                          tsp[0], (tb,))
        trained = tsp[0]
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_grads(jg, trained, tg)


def test_run_lm_sequential_matches_reference():
    """2 SIL steps of stage 0, 2 CE steps of stage 1 on the live prefix
    and 1 of recovery, the reference's SIL passed across: the same (phase,
    stage, step) records and every loss at the fp32 tier."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec(steps=2, recovery=1)
    jhist = JTrainer(JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                                lambda i: _jbatch(batches[i % 4]), jspec),
                     jspec).run(JRc.lm_sequential_phases(2, recovery=True),
                                params=jparams,
                                sils=[jnp.asarray(sil)])[1]
    _, thist = recipes.run_lm_sequential(
        tcfg, 2, tparams, lambda i: batches[i % 4], tspec,
        sils=[sil_from_numpy(sil, device="cpu")], device="cpu")
    for col in ("phase", "stage", "step"):
        assert thist.column(col) == jhist.column(col)
    assert thist.column("phase") == ["left"] * 2 + ["right"] * 2 + [
        "recovery"]
    v = FP32.compare(_f32(jhist.column("loss")), _f32(thist.column("loss")))
    assert v.ok, v.detail


def test_five_adamw_steps_stay_finite():
    """The reference's regression (tests/test_archs.py), in the config's
    bf16 compute: five AdamW steps at 3e-4 of the whole network's CE on
    one (2, 32) batch keep the loss, the gradients and the params finite,
    and the second loss is not more than 0.5 above the first."""
    cfg = tget("xlstm-125m", smoke=True)
    params = tree_map(lambda t: t.clone(), world()[3])
    tok, lab = tokens(cfg, 2, 32, 3), tokens(cfg, 2, 32, 4)
    opt = make_optimizer("adamw", 3e-4)
    state = opt.init(params)
    losses = []
    for _ in range(5):
        ps = tree_map(lambda t: t.requires_grad_(True), params)
        logits, aux = TM.forward(cfg, ps, {"tokens": torch.from_numpy(tok)})
        loss = TLoss.train_objective(cfg, logits, torch.from_numpy(lab),
                                     aux)[0]
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        params = tree_map(lambda t: t.detach(), ps)
        params, state = opt.update(list(grads), state, params)
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)), losses
    assert losses[1] < losses[0] + 0.5
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
