"""The port's vision frontend (llava-next-34b's smoke config: 2 layers, d
256, 4/2 heads of 64, 16 image rows, vocab 512) against ``repro`` on the
CPU.

The encoder is a stub in both packages: each request's (vision_tokens,
d_model) patch embeddings enter as ``image_embeds``, are projected by
``img_proj`` in the compute dtype and prepended to the text.  Weights come
from the reference's ``init_params`` through ``repro_torch.convert``;
tokens, labels and image rows from a numpy seed, the same arrays in both
packages.  fp32 activations and logits are held at the fp32 tier (rtol
1e-5, atol 1e-5 of the tensor's largest magnitude: a matmul's
summation-order error scales with its output), gradients leaf by leaf the
same way.  Covered: the config, ``param_counts`` and the full-size tree
(34.44 B params), ``embed_inputs`` and ``n_prefix``, the forward's logits,
prefill then decode, the stage chain against the whole forward, greedy
engine tokens on both pools against the reference engine (requests with
and without image rows) and staged against the reference's staged engine,
shared prefixes off, the three stage steps' losses and gradients (labels
on the text rows only), ``run_lm_sequential``, Fig. 3's stored boundary,
and Fig. 5's refusal beside the reference's own failure.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import losses as JL
from repro.core import partition as JP
from repro.core import sil as JS
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro.serve import Engine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import Request as JRequest
from repro.serve.kv_cache import PagedCachePool as JPagedCachePool
from repro.train import (BoundaryMaterializePhase as JMaterialize,
                         FrozenPrefixPhase as JFrozen, LMBackend as JLMBackend,
                         SilStagePhase as JSil, Trainer as JTrainer)
from repro.train import recipes as JRc
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_numpy, sil_from_numpy
from repro_torch.core import partition as TP
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO
from repro_torch.serve import Engine, GenerationConfig, Request
from repro_torch.serve.kv_cache import PagedCachePool
from repro_torch.train import (BoundaryMaterializePhase, FrozenPrefixPhase,
                               LMBackend, SilStagePhase, Trainer, recipes)
from repro_torch.train.backends import value_and_accum_grads
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.verify.compare import Allclose

from test_torch_lm_train import _f32, _spec
from test_torch_whisper_train import _assert_grads

ARCH = "llava-next-34b"
B, S = 2, 12
FP32 = Allclose()                          # rtol 1e-5, atol 1e-6


@functools.lru_cache(maxsize=None)
def world():
    """(jax cfg, jax params, port cfg, port params) of the fp32 smoke
    config."""
    jcfg = jget(ARCH, smoke=True).replace(dtype="float32")
    tcfg = tget(ARCH, smoke=True).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def image_rows(cfg, b, seed=0):
    """(b, vision_tokens, d) fp32 patch embeddings of the stubbed
    encoder, at the scale ``tests/conftest.py`` draws them."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, cfg.vision_tokens, cfg.d_model) * 0.02).astype(
        np.float32)


def batch(cfg, b=B, s=S, seed=0):
    """numpy {"tokens", "labels", "image_embeds"}: labels for the text rows
    alone."""
    rng = np.random.RandomState(seed + 1)
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "image_embeds": image_rows(cfg, b, seed)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(want, got, what=""):
    want, got = _np(want), _np(got)
    v = Allclose(rtol=1e-5, atol=1e-5 * max(float(np.abs(want).max()),
                                            1e-30)).compare(want, got)
    assert v.ok, f"{what}: {v.detail}"


# -- config and params ---------------------------------------------------------

def test_config_and_param_counts_match_reference():
    """Every field the port keeps, and the reference's analytic
    ``param_counts`` for every ported arch, full and smoke (the cost
    table's FLOPs read them)."""
    assert ARCH in ARCH_NAMES
    for smoke in (False, True):
        j, t = jget(ARCH, smoke=smoke), tget(ARCH, smoke=smoke)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "vocab_padded", "hd",
                  "norm", "mlp_type", "tie_embeddings", "frontend",
                  "vision_tokens", "max_seq", "param_dtype", "dtype",
                  "source"):
            assert getattr(j, f) == getattr(t, f), f
        for arch in ARCH_NAMES:
            assert tget(arch, smoke=smoke).param_counts() == \
                jget(arch, smoke=smoke).param_counts(), arch
    assert tget(ARCH).q_per_kv == 7


def test_full_size_tree_matches_the_reference_shapes():
    """The full config's tree on the meta device: every leaf of the
    reference's (``jax.eval_shape``, its stacked ``groups`` unstacked) with
    the same shape and dtype: 34,440,297,472 bf16 params, the untied
    64,000 x 7168 tables and ``img_proj`` (7168, 7168)."""
    cfg = tget(ARCH)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    shapes = jax.eval_shape(lambda: JM.init_params(jget(ARCH),
                                                   jax.random.PRNGKey(0)))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in flat(v, f"{prefix}/{i}").items()}
        return {prefix: (tuple(tree.shape), str(tree.dtype).replace(
            "torch.", ""))}
    want = {}
    for k, v in shapes.items():
        if k == "groups":
            for g in range(jax.tree_util.tree_leaves(v)[0].shape[0]):
                want.update(flat(jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), v),
                    f"/{k}/{g}"))
        else:
            want.update(flat(v, f"/{k}"))
    assert flat(params) == want
    assert sum(t.numel() for t in tree_leaves(params)) == 34_440_297_472
    assert want["/img_proj/w"] == ((7168, 7168), "bfloat16")


# -- embed, forward, prefill, decode -------------------------------------------

def test_embed_inputs_and_logits_match_reference():
    """The projected image rows before the text, ``n_prefix`` = 16, the
    logits over every row, in both packages; the compute copy casts
    ``img_proj`` as every dense weight."""
    jcfg, jparams, tcfg, tparams = world()
    b = batch(jcfg)
    jx, jenc, jn = jax.jit(lambda p, x: JM.embed_inputs(jcfg, p, x),
                           static_argnums=())(jparams, jbatch(b))
    tx, tenc, tn = TM.embed_inputs(tcfg, tparams, tbatch(b))
    assert tenc is None and jenc is None
    assert tn == int(jn) == tcfg.vision_tokens == 16
    assert tuple(tx.shape) == (B, 16 + S, tcfg.d_model)
    close(jx, tx, "embed_inputs")
    jl, jaux = jax.jit(lambda p, x: JM.forward(jcfg, p, x, remat=False))(
        jparams, jbatch(b))
    tl, aux = TM.forward(tcfg, tparams, tbatch(b), remat=False)
    assert tuple(tl.shape) == (B, 16 + S, tcfg.vocab_padded)
    close(jl, tl, "forward logits")
    assert aux["n_prefix"] == int(jaux["n_prefix"]) == 16
    copy = TM.compute_copy(tparams, torch.bfloat16)
    assert copy["img_proj"]["w"].dtype == torch.bfloat16


def test_prefill_then_decode_matches_reference():
    """The prompt's last logits after the image rows, the next position
    (image rows + prompt), and two decode steps against the reference and
    against the whole forward at the next row."""
    jcfg, jparams, tcfg, tparams = world()
    b = batch(jcfg, s=S + 2, seed=3)
    pre = {"tokens": b["tokens"][:, :S], "image_embeds": b["image_embeds"]}
    lc = 16 + S + 8
    jl0, jc, jpos = jax.jit(lambda p, x: JM.prefill(jcfg, p, x, lc))(
        jparams, jbatch(pre))
    tl0, tc, tpos = TM.prefill(tcfg, tparams, tbatch(pre), cache_len=lc)
    close(jl0, tl0, "prefill logits")
    assert tpos == int(jpos) == 16 + S
    full, _ = TM.forward(tcfg, tparams, tbatch(b), remat=False)
    for i in range(2):
        tok = b["tokens"][:, S + i]
        jl, jc = jax.jit(lambda p, c, t, q: JM.decode_step(jcfg, p, c, t, q))(
            jparams, jc, jnp.asarray(tok), jnp.asarray(tpos + i))
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.from_numpy(tok).long(), tpos + i)
        close(jl, tl, f"decode step {i}")
        close(full[:, 16 + S + i], tl, f"decode step {i} against forward")


def test_stage_chain_equals_full_forward():
    """Stage 0 owns ``img_proj`` and prepends the image rows; the boundary
    carries them across the cut; the chain equals the whole forward and
    the reference's chain."""
    jcfg, jparams, tcfg, tparams = world()
    b = batch(jcfg)
    plan, jplan = TP.make_plan(tcfg, 2), JP.make_plan(jcfg, 2)
    assert TP.stage_param_keys(tcfg, plan, 0) == JP.stage_param_keys(
        jcfg, jplan, 0) == ["groups", "tok_embed", "img_proj"]
    full, _ = TM.forward(tcfg, tparams, tbatch(b), remat=False)
    x, jx = tbatch(b), jbatch(b)
    for k in range(2):
        sp = TP.slice_stage_params(tcfg, plan, tparams, k)
        jsp = JP.slice_stage_params(jcfg, jplan, jparams, k)
        x, aux = TP.stage_forward(tcfg, plan, k, sp, x, remat=False)
        jx, jaux = JP.stage_forward(jcfg, jplan, k, jsp, jx, remat=False)
        assert aux["n_prefix"] == int(jaux["n_prefix"]) == (16 if k == 0
                                                             else 0)
        if k == 0:
            assert tuple(x.shape) == (B, 16 + S, tcfg.d_model)
            close(jx, x, "stage 0's boundary")
    torch.testing.assert_close(x, full, rtol=1e-6, atol=1e-6)
    close(jx, x, "chained logits")
    joined = TP.join_stage_params(tcfg, plan, [
        TP.slice_stage_params(tcfg, plan, tparams, k) for k in range(2)])
    assert sorted(joined) == sorted(tparams)


# -- serving -------------------------------------------------------------------

def _requests(cfg, lens=(8, 8, 8, 8), news=(8, 4, 8, 4)):
    """(reference, port) request pairs: each with its own image rows but
    the third, which has none (the engine's zero stub)."""
    rng = np.random.RandomState(0)
    out = []
    for i, (ln, nn) in enumerate(zip(lens, news)):
        t = rng.randint(0, cfg.vocab_size, size=(ln,)).astype(np.int32)
        img = None if i == 2 else image_rows(cfg, 1, seed=10 + i)[0]
        out.append((JRequest(tokens=t, gen=JGen(max_new_tokens=nn),
                             image_embeds=img),
                    Request(tokens=t, gen=GenerationConfig(max_new_tokens=nn),
                            image_embeds=img)))
    return out


@functools.lru_cache(maxsize=None)
def _reference_tokens(staged=False):
    jcfg, jparams, _, _ = world()
    reqs = [j for j, _ in _requests(jcfg)]
    kw = dict(max_slots=2, decode_block=4)
    if staged:
        jplan = JP.make_plan(jcfg, 2)
        jsp = [JP.slice_stage_params(jcfg, jplan, jparams, k)
               for k in range(2)]
        done = JEngine(jcfg, plan=jplan, stage_params=jsp, **kw).generate(
            reqs)
    else:
        done = JEngine(jcfg, jparams, **kw).generate(reqs)
    return [c.tokens for c in done], [c.finish_reason for c in done]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_greedy_engine_tokens_match_reference(paged):
    """Four requests through two slots (slots reused, requests finishing at
    different steps), one without image rows: tokens and finish reasons
    equal the reference engine's; the pool holds the image rows (cache
    length image rows + prompt + new tokens)."""
    jcfg, _, tcfg, tparams = world()
    eng = Engine(tcfg, tparams, device="cpu", max_slots=2, decode_block=4,
                 paged=paged)
    got = eng.generate([t for _, t in _requests(jcfg)])
    tokens, reasons = _reference_tokens()
    assert [c.tokens for c in got] == tokens
    assert [c.finish_reason for c in got] == reasons
    assert eng._pool.cache_len >= 16 + 8 + 8


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_staged_engine_matches_reference_staged(paged):
    """The partitions served unjoined (stage 0 with ``img_proj``) give the
    reference's staged engine's tokens."""
    jcfg, _, tcfg, tparams = world()
    plan = TP.make_plan(tcfg, 2)
    stages = [TP.slice_stage_params(tcfg, plan, tparams, k) for k in range(2)]
    got = Engine(tcfg, plan=plan, stage_params=stages, device="cpu",
                 max_slots=2, decode_block=4, paged=paged).generate(
        [t for _, t in _requests(jcfg)])
    assert [c.tokens for c in got] == _reference_tokens(staged=True)[0]


def test_shared_prefixes_are_off_for_vision():
    """A request's text K/V depend on its image rows before them, so no
    prompt block is shared, in either package."""
    jcfg, _, tcfg, _ = world()
    assert not PagedCachePool(tcfg, 2, 64, device="cpu").share_prefixes
    assert not JPagedCachePool(jcfg, 2, 64).share_prefixes


# -- training ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def setup():
    """The fp32 world, one (d, vocab) SIL table and four batches with image
    rows."""
    jcfg, jparams, tcfg, tparams = world()
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    batches = [batch(jcfg, seed=10 + i) for i in range(4)]
    return jcfg, jparams, tcfg, tparams, sil, batches


def _backends(jspec, tspec):
    jcfg, _, tcfg, _, _, batches = setup()
    jbe = JLMBackend(jcfg, JP.make_plan(jcfg, 2),
                     lambda i: jbatch(batches[i % 4]), jspec)
    tbe = LMBackend(tcfg, TP.make_plan(tcfg, 2), lambda i: batches[i % 4],
                    tspec, device="cpu")
    return jbe, tbe


@pytest.mark.parametrize("step", ["left", "right", "recovery"])
def test_stage_step_loss_and_grads_match_reference(step):
    """The three step functions' loss and gradients on the first batch, the
    labels on the text rows only (the image rows trimmed off the boundary
    and the logits): stage 0 against its SIL, stage 1 with CE on the live
    frozen prefix, stage 0 trained through the frozen stage 1."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec()
    jbe, tbe = _backends(jspec, tspec)
    jplan = JP.make_plan(jcfg, 2)
    jsp, tsp = jbe.split(jparams), tbe.split(tparams)
    jb, tb = jbatch(batches[0]), tbe.batch_fn(0)
    labels = jb["labels"]
    nv = jcfg.vision_tokens

    def jstage(k, p, x):
        return JP.stage_forward(jcfg, jplan, k, p, x, remat=False)

    def jce(out):
        logits, aux = out
        return JL.train_objective(jcfg, logits[:, nv:], labels, aux,
                                  None)[0]
    if step == "left":
        jloss, jg = jax.jit(jax.value_and_grad(lambda p: JL.sil_stage_loss(
            jstage(0, p, jb)[0][:, nv:], jnp.asarray(sil), labels)))(jsp[0])
        tloss, tg = value_and_accum_grads(
            tbe.stage_loss(0, sil_from_numpy(sil, device="cpu"), {}),
            tsp[0], (tb, tb["labels"], None))
        trained = tsp[0]
    elif step == "right":
        h = jax.jit(lambda p: jstage(0, p, jb)[0])(jsp[0])
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jce(jstage(1, p, h))))(jsp[1])
        th = tbe.prefix_forward(1)((tsp[0],), tb)
        assert tuple(th.shape) == (B, nv + S, tcfg.d_model)
        tloss, tg = value_and_accum_grads(tbe.stage_loss(1, None, {}),
                                          tsp[1], (th, tb["labels"], None))
        trained = tsp[1]
    else:
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jce(jstage(1, jsp[1], jstage(0, p, jb)[0]))))(jsp[0])
        frozen = [tree_map(lambda t: t.detach(), sp) for sp in tsp]
        tloss, tg = value_and_accum_grads(tbe.recovery_loss(0, frozen, {}),
                                          tsp[0], (tb,))
        trained = tsp[0]
    v = FP32.compare(_f32(jloss), tloss.numpy())
    assert v.ok, v.detail
    _assert_grads(jg, trained, tg)


def test_run_lm_sequential_matches_reference():
    """A SIL step of stage 0, a CE step of stage 1 on the live prefix, one
    of recovery, the reference's SIL passed across, on a plan that
    ``"auto"`` searched (the even split here): the same (phase, stage,
    step) records and every loss at the fp32 tier."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec(steps=1, recovery=1)
    jplan = JRc.resolve_plan(jcfg, "auto")
    jhist = JTrainer(JLMBackend(jcfg, jplan, lambda i: jbatch(batches[i % 4]),
                                jspec), jspec).run(
        JRc.lm_sequential_phases(2, recovery=True), params=jparams,
        sils=[jnp.asarray(sil)])[1]
    assert recipes.resolve_plan(tcfg, "auto").bounds == jplan.bounds
    _, thist = recipes.run_lm_sequential(
        tcfg, "auto", tparams, lambda i: batches[i % 4], tspec,
        sils=[sil_from_numpy(sil, device="cpu")], device="cpu")
    for col in ("phase", "stage", "step"):
        assert thist.column(col) == jhist.column(col)
    assert len(thist.column("loss")) == 3
    v = FP32.compare(_f32(jhist.column("loss")), _f32(thist.column("loss")))
    assert v.ok, v.detail


def test_fig3_stored_boundary_matches_reference():
    """Fig. 3 as the reference composes it for a vision config: stage 0's
    SIL step, the frozen stage 0 over 2 batches into the cache (image rows
    and text rows, (2 B, 16 + S, d)), stage 1's CE step on the stored
    rows, the image rows trimmed off their logits: every loss at the fp32
    tier, labels bit for bit."""
    jcfg, jparams, tcfg, tparams, sil, _ = setup()
    jspec, tspec = _spec(steps=1)
    jbe, tbe = _backends(jspec, tspec)
    rows = {}

    class Capture:
        needs_sil = False

        def __init__(self, key):
            self.key = key

        def run(self, trainer, state):
            rows[self.key] = (state.boundary["h"].array().shape,
                              np.asarray(state.boundary["labels"]))

    def phases(Sil, M, F, key):
        return [Sil(stage=0), M(upto=1, n_batches=2), Capture(key),
                F(stage=1, source="cache")]
    jhist = JTrainer(jbe, jspec).run(
        phases(JSil, JMaterialize, JFrozen, "ref"), params=jparams,
        sils=[jnp.asarray(sil)])[1]
    thist = Trainer(tbe, tspec).run(
        phases(SilStagePhase, BoundaryMaterializePhase, FrozenPrefixPhase,
               "port"), params=tparams,
        sils=[sil_from_numpy(sil, device="cpu")])[1]
    assert rows["port"][0] == rows["ref"][0] == (2 * B, 16 + S,
                                                 tcfg.d_model)
    np.testing.assert_array_equal(rows["port"][1], rows["ref"][1])
    assert thist.column("phase") == jhist.column("phase")
    v = FP32.compare(_f32(jhist.column("loss")), _f32(thist.column("loss")))
    assert v.ok, v.detail


def test_fig5_refuses_vision_as_the_reference_fails():
    """Fig. 5's stage 1 runs on SIL[:, y], the text rows alone: the
    reference's stage step fails on it (its vision trim leaves shapes that
    do not broadcast), and the port refuses it, naming that failure, from
    the stage step, the synthetic input and ``run_lm_parallel``."""
    jcfg, jparams, tcfg, tparams, sil, batches = setup()
    jspec, tspec = _spec()
    jbe, tbe = _backends(jspec, tspec)
    labels = batches[0]["labels"]
    jsp = jbe.split(jparams)[1]
    jopt = JO.adamw(1e-3)
    jstep = jbe.build_parallel_stage_step(1, jopt, jnp.asarray(sil), None,
                                          jsp)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jstep(jsp, jopt.init(jbe.trainable(jsp)), jnp.asarray(labels))
    tsil = sil_from_numpy(sil, device="cpu")
    with pytest.raises(ValueError, match="Incompatible shapes"):
        tbe.build_parallel_stage_step(1, TO.adamw(1e-3), tsil, None)
    with pytest.raises(ValueError, match="Fig. 5 stage 1"):
        tbe.synthetic_input(1, [tsil], torch.from_numpy(labels).long())
    with pytest.raises(ValueError, match="Incompatible shapes"):
        recipes.run_lm_parallel(tcfg, 2, tparams, lambda i: batches[i % 4],
                                tspec, sils=[tsil], device="cpu")


def test_training_cli_refuses_vision():
    """The CLI's token stream carries no image rows (the reference's
    neither): it refuses llava-next-34b with a message instead of a missing
    key."""
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match="vision config"):
        launch_train.main(["--arch", ARCH, "--smoke", "--mode", "pnn",
                           "--device", "cpu"])
