"""The port's step builders and input stand-ins (``repro_torch.launch.
{steps,specs}``) against the reference's ``repro.launch.{steps,specs}`` on
the CPU.

The step builders run on qwen2-1.5b's smoke config in fp32 (2 layers, d 256,
vocab 512) from the reference's ``init_params``, handed across with
``repro_torch.convert``, on the same numpy batches; the reference side is
jitted once a function.  Losses, ``ce`` and ``grad_norm`` are held at the
fp32 tier (rtol 1e-5, atol 1e-6), logits at the tier's rtol with an atol of
1e-5 of their largest magnitude, and the params after two AdamW steps as
``tests/test_torch_lm_train.py`` holds them (all but 1% of a leaf's elements
at the fp32 tier, every element within 2 lr a step: see its docstring).
``pick_accum`` is held against the reference's with one data shard (no
policy); with a ``Policy`` in tests/test_torch_sharding.py.  The stand-ins are ``meta`` tensors, held against the
reference's ``ShapeDtypeStruct``s by shape and dtype name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCHS
from repro.configs import get as j_get
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.core import partition as JP
from repro.core import sil as JS
from repro.launch import specs as JSpecs
from repro.launch import steps as JSteps
from repro.models import model as JM
from repro.optim import cosine_warmup as j_cosine
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch import precision as TPrec
from repro_torch.configs import ARCH_NAMES, get
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.convert import params_from_numpy, sil_from_numpy
from repro_torch.core import partition as TP
from repro_torch.data import lm as TD
from repro_torch.launch import specs as TSpecs
from repro_torch.launch import steps as TSteps
from repro_torch.models import model as TM
from repro_torch.optim import cosine_warmup, make_optimizer
from repro_torch.serve import Engine
from repro_torch.tree import tree_leaves
from repro_torch.verify.compare import Allclose
from test_torch_lm_train import (_act, _assert_params, _f32, _flat,
                                 _jbatch, _np_tree, _port_layout, _tbatch)
from _torch_threads import _one_thread  # noqa: F401

FP32 = Allclose()                          # rtol 1e-5, atol 1e-6
B, S = 4, 16
LR = 1e-3


@pytest.fixture(scope="module")
def world():
    """fp32 smoke configs, the reference's params, and two (B, S) batches."""
    jcfg = j_get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    stream = TD.synthetic_token_stream(4000, jcfg.vocab_size, seed=0)
    it = TD.lm_batches(stream, B, S, seed=0)
    return jcfg, tcfg, jparams, [next(it) for _ in range(2)]


def _tparams(tcfg, jparams):
    return params_from_numpy(tcfg, _np_tree(jparams), device="cpu")


# -- build_train_step -----------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(world, accum):
    """Two steps of the unpartitioned train step with the CLI's optimizer
    (AdamW on cosine_warmup): loss, ce and grad_norm a step, then the
    params."""
    jcfg, tcfg, jparams, batches = world
    jopt = j_make_optimizer("adamw", j_cosine(LR, 10, 2))
    jstep = jax.jit(JSteps.build_train_step(jcfg, jopt, accum=accum))
    jp, js = jparams, jopt.init(jparams)
    topt = make_optimizer("adamw", cosine_warmup(LR, 10, 2))
    tstep = TSteps.build_train_step(tcfg, topt, accum=accum)
    tp = _tparams(tcfg, jparams)
    ts = topt.init(tp)
    for b in batches:
        jp, js, jm = jstep(jp, js, _jbatch(b))
        tp, ts, tm = tstep(tp, ts, _tbatch(b))
        assert sorted(tm) == sorted(jm) == ["ce", "grad_norm", "loss"]
        for k in jm:
            v = FP32.compare(_f32(jm[k]), _f32(tm[k].item()))
            assert v.ok, f"{k}: {v.detail}"
    _assert_params(jp, tp, LR, len(batches))


def test_train_step_keeps_param_dtype_under_bf16():
    """The port's counterpart of tests/test_precision.py's: under the bf16
    policy the params keep their param dtype and ce is finite."""
    cfg = TPrec.get_policy("bf16").apply_to_model(
        get("qwen2-1.5b", smoke=True))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = make_optimizer("adamw", 1e-3)
    state = opt.init(params)
    batch = {"tokens": torch.ones((2, 16), dtype=torch.long),
             "labels": torch.ones((2, 16), dtype=torch.long)}
    params, state, metrics = TSteps.build_train_step(cfg, opt)(
        params, state, batch)
    for leaf in tree_leaves(params):
        if leaf.is_floating_point():
            assert leaf.dtype == torch.float32 == \
                getattr(torch, cfg.param_dtype)
    assert np.isfinite(float(metrics["ce"]))


# -- build_pnn_stage_step ----------------------------------------------------

def test_pnn_stage_step_matches_reference(world):
    """Stage 0's SIL-MSE and stage 1's CE step of a 2-stage plan, the
    second on the boundary the port's stage-0 forward gives (the same input
    to both): both losses, then each stage's params."""
    jcfg, tcfg, jparams, batches = world
    jplan, tplan = JP.make_plan(jcfg, 2), TP.make_plan(tcfg, 2)
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    jb, tb = _jbatch(batches[0]), _tbatch(batches[0])
    with torch.no_grad():
        xin = TP.stage_forward(tcfg, tplan, 0, TP.slice_stage_params(
            tcfg, tplan, _tparams(tcfg, jparams), 0), tb, remat=False)[0]
    xin = xin.numpy()
    args = {0: ((jb, jnp.asarray(sil)), (tb, sil_from_numpy(sil, "cpu"))),
            1: ((jnp.asarray(xin), None), (torch.from_numpy(xin.copy()), None))}
    for k in (0, 1):
        jsp = JP.slice_stage_params(jcfg, jplan, jparams, k)
        # a fresh copy a stage: the port's optimizer updates in place, and
        # the last stage's tied_unembed aliases stage 0's tok_embed
        tsp = TP.slice_stage_params(tcfg, tplan, _tparams(tcfg, jparams), k)
        jopt, topt = (j_make_optimizer("adamw", LR),
                      make_optimizer("adamw", LR))
        (jx, jsil), (tx, tsil) = args[k]
        jp, _, jl = jax.jit(JSteps.build_pnn_stage_step(
            jcfg, jplan, k, jopt))(jsp, jopt.init(jsp), jx, jb["labels"],
                                   jsil)
        tp, _, tl = TSteps.build_pnn_stage_step(tcfg, tplan, k, topt)(
            tsp, topt.init(tsp), tx, tb["labels"], tsil)
        v = FP32.compare(_f32(jl), _f32(tl.item()))
        assert v.ok, f"stage {k}: {v.detail}"
        _assert_params(jp, tp, LR, 1)


# -- prefill and decode steps -------------------------------------------------

def test_prefill_and_decode_steps_match_reference(world):
    jcfg, tcfg, jparams, batches = world
    tparams = _tparams(tcfg, jparams)
    tokens = batches[0]["tokens"][:2, :12]
    jl, jc, jpos = jax.jit(JSteps.build_prefill_step(jcfg, 24),
                           )(jparams, {"tokens": jnp.asarray(tokens)})
    tl, tc, tpos = TSteps.build_prefill_step(tcfg, 24)(
        tparams, {"tokens": torch.from_numpy(np.array(tokens)).long()})
    assert int(jpos) == tpos == 12
    ref = np.asarray(jl)
    v = _act(ref).compare(ref, tl.numpy())
    assert v.ok, v.detail
    _same_cache(jc, tc)
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    jl2, jc2 = jax.jit(JSteps.build_decode_step(jcfg))(
        jparams, jc, jnp.asarray(tok), jnp.int32(12))
    tl2, tc2 = TSteps.build_decode_step(tcfg)(
        tparams, tc, torch.from_numpy(tok).long(), 12)
    ref = np.asarray(jl2)
    v = _act(ref).compare(ref, tl2.numpy())
    assert v.ok, v.detail
    _same_cache(jc2, tc2)


def _same_cache(jc, tc):
    ref, got = _flat(_np_tree(jc)), _flat(tc)
    assert sorted(ref) == sorted(got)
    for k in ref:
        v = _act(ref[k]).compare(ref[k], got[k])
        assert v.ok, f"{k}: {v.detail}"


# -- pick_optimizer_name / pick_accum -------------------------------------------

class _OneShard:
    """The reference's Policy seen by ``pick_accum`` on one data shard."""
    class mesh:
        shape = {}

    @staticmethod
    def batch_entry(_):
        return ()


def test_pick_optimizer_and_accum_match_reference():
    assert sorted(ARCH_NAMES) == sorted(J_ARCHS) and len(ARCH_NAMES) == 10
    assert sorted(INPUT_SHAPES) == sorted(J_SHAPES)
    for name in ARCH_NAMES:
        jcfg, tcfg = j_get(name), get(name)
        assert TSteps.pick_optimizer_name(tcfg) == \
            JSteps.pick_optimizer_name(jcfg), name
        for sname, shape in INPUT_SHAPES.items():
            assert shape == TSpecs.InputShape(*J_SHAPES[sname].__dict__
                                              .values())
            assert TSteps.pick_accum(tcfg, shape) == JSteps.pick_accum(
                jcfg, J_SHAPES[sname], _OneShard), (name, sname)


@pytest.mark.parametrize("kw", ["seq_shard_fn", "grad_pspecs", "policy"])
def test_mesh_hooks_raise(kw):
    """The hooks that constrain tensors on a mesh of cards raise, naming
    the machine they wait for.  ``policy``: ``pick_accum`` takes a
    ``launch.sharding.Policy`` now (held in tests/test_torch_sharding.py);
    the engine's sharded mode still waits."""
    cfg = get("qwen2-1.5b", smoke=True)
    if kw == "policy":
        with pytest.raises(NotImplementedError,
                           match="more than one card.*ROADMAP queue A, "
                                 "step 5"):
            Engine(cfg, None, seed=0, device="cpu", policy=object())
        return
    with pytest.raises(ValueError, match="more than one card.*ROADMAP "
                                         "queue A, step 5"):
        TSteps.build_train_step(cfg, make_optimizer("adamw", LR),
                                **{kw: object()})
    with pytest.raises(ValueError, match="ROADMAP queue A, step 5"):
        TSteps.build_pnn_stage_step(cfg, TP.make_plan(cfg, 2), 0,
                                    make_optimizer("adamw", LR),
                                    **{kw: object()})


# -- specs ----------------------------------------------------------------------

def _same_specs(jtree, ttree, where):
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree), where
        for k in jtree:
            _same_specs(jtree[k], ttree[k], f"{where}/{k}")
        return
    assert ttree.device.type == "meta", where
    assert tuple(ttree.shape) == tuple(jtree.shape), where
    assert str(ttree.dtype).removeprefix("torch.") == \
        jnp.dtype(jtree.dtype).name, where


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_reference(arch):
    """Every input shape: the (shape-conditional) config, applicability,
    the train and prefill batch stand-ins and decode's (cache, token, pos),
    the cache built by ``init_cache`` on the meta device."""
    for sname in INPUT_SHAPES:
        jshape, tshape = J_SHAPES[sname], INPUT_SHAPES[sname]
        jcfg = JSpecs.arch_for_shape(j_get(arch), jshape)
        tcfg = TSpecs.arch_for_shape(get(arch), tshape)
        where = f"{arch}/{sname}"
        assert tcfg.sliding_window == jcfg.sliding_window, where
        assert TSpecs.applicable(tcfg, tshape) == \
            JSpecs.applicable(jcfg, jshape), where
        _same_specs(JSpecs.train_batch_specs(jcfg, jshape),
                    TSpecs.train_batch_specs(tcfg, tshape), where)
        _same_specs(JSpecs.prefill_batch_specs(jcfg, jshape),
                    TSpecs.prefill_batch_specs(tcfg, tshape), where)
        if not TSpecs.applicable(tcfg, tshape)[0]:
            continue
        jcache, jtok, jpos = JSpecs.decode_specs(jcfg, jshape)
        tcache, ttok, tpos = TSpecs.decode_specs(tcfg, tshape)
        _same_specs(jcache, tcache, where + "/cache")
        _same_specs({"token": jtok, "pos": jpos},
                    {"token": ttok, "pos": tpos}, where)
