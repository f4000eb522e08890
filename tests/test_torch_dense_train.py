"""Stage-by-stage training of the dense configs of tests/test_torch_dense.py
in the port against ``repro`` on the CPU: on the smoke configs of
stablelm-3b (LayerNorm, MHA) and chatglm3-6b (2 KV heads, QKV bias), one
SIL stage step of stage 0 and one recovery step (§5) through the frozen
last stage.  Params and SIL tables come from the reference through
``repro_torch.convert``; the token data is numpy in both packages.  The
loss at the fp32 tier (rtol 1e-5, atol 1e-6), then the params after one
AdamW step as tests/test_torch_lm_train.py holds them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as JP
from repro.core import sil as JS
from repro.optim import optimizers as JO
from repro.train import LMBackend as JLMBackend
from repro_torch.convert import sil_from_numpy
from repro_torch.core import partition as TP
from repro_torch.data import lm as TD
from repro_torch.optim import optimizers as TO
from repro_torch.train import LMBackend
from repro_torch.verify.compare import Allclose

from test_torch_dense import world
from test_torch_lm_train import _assert_params, _f32, _spec

FP32 = Allclose()                          # rtol 1e-5, atol 1e-6
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _train_setup(name):
    jcfg, jparams, tcfg, tparams = world(name)
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    it = TD.lm_batches(TD.synthetic_token_stream(8000, jcfg.vocab_size,
                                                 seed=0), B, S, seed=0)
    batches = [next(it) for _ in range(2)]
    jspec, tspec = _spec()
    jbe = JLMBackend(jcfg, JP.make_plan(jcfg, 2), lambda i: {
        k: jnp.asarray(v) for k, v in batches[i % 2].items()}, jspec)
    tbe = LMBackend(tcfg, TP.make_plan(tcfg, 2), lambda i: batches[i % 2],
                    tspec, device="cpu")
    return sil, batches, jbe, tbe


@pytest.mark.parametrize("name", ["stablelm", "chatglm3"])
def test_sil_stage_step_matches_reference(name):
    """Stage 0 on SIL-MSE against its table: the loss, then the params
    after one AdamW step."""
    _, jparams, _, tparams = world(name)
    sil, batches, jbe, tbe = _train_setup(name)
    jsp, tsp = jbe.split(jparams)[0], tbe.split(tparams)[0]
    jopt, topt = JO.adamw(1e-3), TO.adamw(1e-3)
    jstep = jbe.build_stage_step(0, jopt, jnp.asarray(sil), jsp)
    tstep = tbe.build_stage_step(0, topt, sil_from_numpy(sil, device="cpu"))
    labels = batches[0]["labels"]
    jnew, _, jloss = jstep(jsp, jopt.init(jbe.trainable(jsp)),
                           jbe.batch_fn(0), jnp.asarray(labels))
    tnew, _, tloss = tstep(tsp, topt.init(tbe.trainable(tsp)),
                           tbe.batch_fn(0), torch.from_numpy(labels).long())
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)


@pytest.mark.parametrize("name", ["stablelm", "chatglm3"])
def test_recovery_step_matches_reference(name):
    """Stage 0 trained through the frozen last stage on CE (§5): the loss,
    then the params after one AdamW step."""
    _, jparams, _, tparams = world(name)
    _, _, jbe, tbe = _train_setup(name)
    jsp, tsp = jbe.split(jparams), tbe.split(tparams)
    jbe.before_stage_train(jsp, 1)
    tbe.before_stage_train(tsp, 1)
    jopt, topt = JO.adamw(1e-3), TO.adamw(1e-3)
    jstep = jbe.build_recovery_step(0, list(jsp), jopt)
    tstep = tbe.build_recovery_step(0, list(tsp), topt)
    jnew, _, jloss = jstep(jsp[0], jopt.init(jsp[0]), jbe.batch_fn(1))
    tnew, _, tloss = tstep(tsp[0], topt.init(tsp[0]), tbe.batch_fn(1))
    assert FP32.compare(_f32(jloss), tloss.numpy()).ok
    _assert_params(jnew, tnew, 1e-3, 1)
