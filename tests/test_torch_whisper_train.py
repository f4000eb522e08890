"""Stage-by-stage training of whisper-tiny's smoke config (2 encoder and 2
decoder layers, d 128; tests/test_torch_whisper.py) in the port against
``repro`` on the CPU, over a 2-stage plan whose stage 0 owns the encoder
and hands ``(x, enc_out)`` across the cut.

Params and the SIL table come from the reference through
``repro_torch.convert``; tokens, labels and frames are numpy arrays shared
by both packages.  Each step function's loss and gradients on one batch
(the SIL stage, stage 1's CE on the live frozen prefix, recovery through
the frozen stage 1) at the fp32 tier, every gradient leaf held at rtol
1e-5 and atol 1e-5 of the leaf's largest magnitude (a matmul's
summation-order error scales with its output); then ``run_lm_sequential``
(2 steps a stage, 2 of recovery): every loss at the fp32 tier.  Fig. 5's
stage 1 runs on ``(SIL[:, y], None)``, without its cross blocks (their
gradients are zeros, as JAX's of an unused argument): its loss and params
after one AdamW step as tests/test_torch_lm_train.py holds them.  The
boundary materialization of the enc-dec payload raises in both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as JL
from repro.core import partition as JP
from repro.core import sil as JS
from repro.optim import optimizers as JO
from repro.train import BoundaryMaterializePhase as JMaterialize
from repro.train import LMBackend as JLMBackend
from repro.train import Trainer as JTrainer
from repro.train import recipes as JRc
from repro_torch.convert import sil_from_numpy
from repro_torch.core import partition as TP
from repro_torch.optim import optimizers as TO
from repro_torch.train import BoundaryMaterializePhase, LMBackend, Trainer
from repro_torch.train import recipes
from repro_torch.train.backends import value_and_accum_grads
from repro_torch.tree import tree_map
from repro_torch.verify.compare import Allclose

from test_torch_lm_train import _assert_params, _f32, _spec
from test_torch_whisper import batch, jbatch, world

FP32 = Allclose()                          # rtol 1e-5, atol 1e-6
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def setup():
    """The fp32 world, one (d, vocab) SIL table and four batches with
    frames."""
    jcfg, jparams, tcfg, tparams = world()
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    batches = [batch(jcfg, b=B, s=S, seed=10 + i) for i in range(4)]
    return jcfg, jparams, tcfg, tparams, sil, batches


def _backends(jspec, tspec):
    jcfg, _, tcfg, _, _, batches = setup()
    jbe = JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                     lambda i: jbatch(batches[i % 4]), jspec)
    tbe = LMBackend(tcfg, TP.make_plan(tcfg, 2), lambda i: batches[i % 4],
                    tspec, device="cpu")
    return jbe, tbe


def _paths(tree, prefix=""):
    """Leaf paths of a port tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def _port_layout_flat(tree, prefix=""):
    """{path: numpy} of a reference tree, its stacked ``groups`` and
    ``encoder`` unstacked as the port lists them."""
    out = {}
    for k, v in tree.items():
        if k in ("groups", "encoder"):
            n = jax.tree_util.tree_leaves(v)[0].shape[0]
            for g in range(n):
                sub = jax.tree.map(lambda a, g=g: a[g], v)
                out.update(_port_layout_flat(sub, f"{prefix}/{k}/{g}"))
        elif isinstance(v, dict):
            out.update(_port_layout_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def _assert_grads(jgrads, tparams, tgrads):
    want = _port_layout_flat(jgrads)
    got = dict(zip(_paths(tparams), (g.float().numpy() for g in tgrads)))
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        v = Allclose(rtol=1e-5, atol=1e-5 * max(float(np.abs(w).max()),
                                                1e-30)).compare(w, got[k])
        assert v.ok, f"{k}: {v.detail}"


@pytest.mark.parametrize("step", ["left", "right", "recovery"])
def test_first_step_loss_and_grads_match_reference(step):
    """The three step functions' loss and gradients on the first batch:
    stage 0 against its SIL on the payload's x, stage 1 with CE on the live
    frozen prefix's payload, stage 0 trained through the frozen stage 1."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec()
    jbe, tbe = _backends(jspec, tspec)
    jplan, plan = JP.make_plan(jcfg, 2), TP.make_plan(tcfg, 2)
    jsp, tsp = jbe.split(jparams), tbe.split(tparams)
    jb, tb = jbatch(batches[0]), tbe.batch_fn(0)
    labels = jb["labels"]

    def jstage(k, p, x):
        return JP.stage_forward(jcfg, jplan, k, p, x, remat=False)

    def jce(out):
        logits, aux = out
        return JL.train_objective(jcfg, logits, labels, aux, None)[0]
    if step == "left":
        jloss, jg = jax.jit(jax.value_and_grad(lambda p: JL.sil_stage_loss(
            jstage(0, p, jb)[0][0], jnp.asarray(sil), labels)))(jsp[0])
        tloss, tg = value_and_accum_grads(
            tbe.stage_loss(0, sil_from_numpy(sil, device="cpu"), {}),
            tsp[0], (tb, tb["labels"], None))
        trained = tsp[0]
    elif step == "right":
        payload = jax.jit(lambda p: jstage(0, p, jb)[0])(jsp[0])
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jce(jstage(1, p, payload))))(jsp[1])
        h = tbe.prefix_forward(1)((tsp[0],), tb)
        assert isinstance(h, tuple) and h[1].shape == (B, tcfg.enc_seq,
                                                       tcfg.d_model)
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
    """2 SIL steps of stage 0, 2 CE steps of stage 1 on the live prefix, 2
    of recovery, the reference's SIL passed across: the same (phase,
    stage, step) records and every loss at the fp32 tier."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec(steps=2, recovery=2)
    jhist = JTrainer(JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                                lambda i: jbatch(batches[i % 4]), jspec),
                     jspec).run(JRc.lm_sequential_phases(2, recovery=True),
                                params=jparams,
                                sils=[jnp.asarray(sil)])[1]
    _, thist = recipes.run_lm_sequential(
        tcfg, 2, tparams, lambda i: batches[i % 4], tspec,
        sils=[sil_from_numpy(sil, device="cpu")], device="cpu")
    for col in ("phase", "stage", "step"):
        assert thist.column(col) == jhist.column(col)
    assert len(thist.column("loss")) == 6
    v = FP32.compare(_f32(jhist.column("loss")), _f32(thist.column("loss")))
    assert v.ok, v.detail


def test_fig5_stage_runs_on_syn_and_none():
    """Fig. 5's stage 1 step with the synthetic-input lookup inside: the
    payload ``(SIL[:, y], None)`` reaches no cross block, whose gradients
    are zeros; the loss and the params after one AdamW step match the
    reference's."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec()
    jbe, tbe = _backends(jspec, tspec)
    tsil = sil_from_numpy(sil, device="cpu")
    labels = batches[0]["labels"]
    syn = tbe.synthetic_input(1, [tsil], torch.from_numpy(labels).long())
    assert isinstance(syn, tuple) and syn[1] is None
    jsp, tsp = jbe.split(jparams)[1], tbe.split(tparams)[1]
    jopt, topt = JO.adamw(1e-3), TO.adamw(1e-3)
    jstep = jbe.build_parallel_stage_step(1, jopt, jnp.asarray(sil), None,
                                          jsp)
    tstep = tbe.build_parallel_stage_step(1, topt, tsil, None)
    jnew, _, jloss = jstep(jsp, jopt.init(jbe.trainable(jsp)),
                           jnp.asarray(labels))
    tst = topt.init(tbe.trainable(tsp))
    tnew, tst, tloss = tstep(tsp, tst, torch.from_numpy(labels).long())
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)
    # the cross blocks saw no input: AdamW's first moments stay zero there
    paths = _paths(tbe.trainable(tnew))
    cross = [m for p, m in zip(paths, tst["m"]) if "/cross/" in p]
    assert cross and all(not m.any() for m in cross)
    assert all(m.any() for p, m in zip(paths, tst["m"])
               if "/attn/wq/" in p)


def test_boundary_materialization_refuses_enc_dec_payloads():
    """Both packages refuse to store an enc-dec boundary (the payload holds
    the encoder output too) and point at the live prefix."""
    jcfg, jparams, tcfg, tparams, sil, _ = setup()
    jspec, tspec = _spec()
    jbe, tbe = _backends(jspec, tspec)
    with pytest.raises(NotImplementedError, match="enc-dec payloads"):
        JTrainer(jbe, jspec).run([JMaterialize(upto=1, n_batches=1)],
                                 params=jparams, sils=[jnp.asarray(sil)])
    with pytest.raises(NotImplementedError, match="enc-dec payloads"):
        Trainer(tbe, tspec).run(
            [BoundaryMaterializePhase(upto=1, n_batches=1)], params=tparams,
            sils=[sil_from_numpy(sil, device="cpu")])


def test_training_cli_refuses_enc_dec():
    """The CLI's token stream carries no frames (the reference's neither):
    it refuses whisper-tiny with a message instead of a missing key."""
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match="encoder-decoder"):
        launch_train.main(["--arch", "whisper-tiny", "--smoke", "--mode",
                           "pnn", "--device", "cpu"])


def test_accumulated_step_splits_the_payload():
    """With ``accum`` microbatches the stage-1 payload ``(x, enc_out)`` is
    split along its batch as a tensor batch is: two microbatches of one
    row each give the single-shot mean loss and gradients (the CE's rows
    weigh alike in both halves)."""
    _, _, _, tparams, _, _ = setup()
    _, tbe = _backends(*_spec())
    sp = tbe.split(tparams)
    b = tbe.batch_fn(0)
    h = tbe.prefix_forward(1)((sp[0],), b)
    loss_fn = tbe.stage_loss(1, None, {})
    l1, g1 = value_and_accum_grads(loss_fn, sp[1], (h, b["labels"], None))
    l2, g2 = value_and_accum_grads(loss_fn, sp[1], (h, b["labels"], None),
                                   accum=2)
    torch.testing.assert_close(l2, l1, rtol=1e-5, atol=1e-6)
    for a, c in zip(g1, g2):
        torch.testing.assert_close(c, a, rtol=1e-4, atol=1e-6)
