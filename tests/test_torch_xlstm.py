"""The port's xLSTM (xlstm-125m's smoke config: 4 layers alternating mLSTM
and sLSTM, d 256, 4 heads, chunk 64, LayerNorm, tied vocabulary of 512, no
FFN) against ``repro`` on the CPU.

The weights come from the reference's ``init_params`` through
``repro_torch.convert``; tokens and activations from a numpy seed, the same
arrays in both packages.  fp32 outputs and states are held at the fp32 tier
(rtol 1e-5, atol 1e-5 of the tensor's largest magnitude: a product's
summation-order error scales with its output).  bf16 is held at the
reference's own bf16 error (``Tier`` of tests/test_torch_hybrid.py: the
port's distance to the fp32 reference at most 1.5 x (RMS) and 2 x
(largest) the reference's bf16 run's).  Covered: the config and its block
kinds, the full-size tree (123,643,440 params), the weights carried across
and kept fp32 by the compute copy, each layer alone at lengths that are not
whole chunks (13, 77) from zeros and from a given state, the forward's
logits, prefill then 4 decode steps against teacher-forced forwards
(reference tests/test_decode.py's xLSTM cases), greedy engine tokens on
both pools (chunk-ragged prompts among them), staged serving against
joined, and the pools' initial state (sLSTM's stabiliser at -1e9).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import Request as JRequest
from repro.serve.kv_cache import PagedCachePool as JPagedCachePool
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import partition as TP
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import Engine, GenerationConfig, Request
from repro_torch.serve.kv_cache import CachePool, PagedCachePool
from repro_torch.tree import tree_leaves
from repro_torch.verify.compare import Allclose

from test_torch_hybrid import Tier

ARCH = "xlstm-125m"
SLOT = {"mlstm": "slot_0", "slstm": "slot_1"}
STATE = {"mlstm": ("C", "n"), "slstm": ("h", "c", "sn", "m")}


@functools.lru_cache(maxsize=None)
def world(dtype="float32"):
    """(jax cfg, jax params, port cfg, port params) of the smoke config;
    the weights are fp32 whatever ``dtype`` (the compute dtype)."""
    jcfg = jget(ARCH, smoke=True).replace(dtype=dtype)
    tcfg = tget(ARCH, smoke=True).replace(dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(want, got, what=""):
    want, got = _np(want), _np(got)
    v = Allclose(rtol=1e-5, atol=1e-5 * max(float(np.abs(want).max()),
                                            1e-30)).compare(want, got)
    assert v.ok, f"{what}: {v.detail}"


def tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# -- config and params ---------------------------------------------------------

def test_config_and_block_kinds_match_reference():
    """Every field the port reads, the block kind of each of the 12 layers
    (mLSTM, sLSTM, ...), the group (one mLSTM and one sLSTM slot, no FFN)
    and its count (6), at full size and in the smoke config."""
    assert ARCH in ARCH_NAMES
    for smoke in (False, True):
        j, t = jget(ARCH, smoke=smoke), tget(ARCH, smoke=smoke)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "vocab_padded", "hd",
                  "norm", "mlp_type", "tie_embeddings", "max_seq",
                  "param_dtype", "dtype", "source"):
            assert getattr(j, f) == getattr(t, f), f
        assert (j.xlstm.pattern, j.xlstm.proj_factor, j.xlstm.chunk_size) \
            == (t.xlstm.pattern, t.xlstm.proj_factor, t.xlstm.chunk_size)
        assert [t.block_kind(i) for i in range(t.n_layers)] == [
            j.block_kind(i) for i in range(j.n_layers)]
        assert TM.slot_spec(t) == JM.slot_spec(j) == [
            ("mlstm", False, False), ("slstm", False, False)]
        assert TM.n_groups(t) == JM.n_groups(j)
    assert TM.n_groups(tget(ARCH)) == 6


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace(
        "torch.", ""))}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_full_size_tree_matches_the_reference_shapes(param_dtype):
    """The full config's tree on the meta device: every leaf of the
    reference's (``jax.eval_shape``, its stacked ``groups`` unstacked) with
    the same shape and dtype, 123,643,440 params; mLSTM's gate projections
    stay fp32 under bf16 storage, sLSTM's block-diagonal ``r`` (4, 192,
    768) follows the storage dtype."""
    cfg = tget(ARCH).replace(param_dtype=param_dtype)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    shapes = jax.eval_shape(lambda: JM.init_params(
        jget(ARCH).replace(param_dtype=param_dtype), jax.random.PRNGKey(0)))
    want = {}
    for k, v in shapes.items():
        if k == "groups":
            for g in range(6):
                want.update(_flat(jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), v),
                    f"/{k}/{g}"))
        else:
            want.update(_flat(v, f"/{k}"))
    assert _flat(params) == want
    n = sum(t.numel() for t in tree_leaves(params))
    assert n == sum(int(np.prod(s)) for s, _ in want.values()) == 123_643_440
    m, s = params["groups"][0]["slot_0"], params["groups"][0]["slot_1"]
    assert sorted(m) == ["mlstm", "norm1"] and sorted(s) == ["norm1", "slstm"]
    assert m["mlstm"]["w_i"]["w"].dtype == torch.float32
    assert tuple(s["slstm"]["r"].shape) == (4, 192, 768)
    assert tuple(m["mlstm"]["wq"]["w"].shape) == (1536, 1536)


def test_weights_cross_and_the_compute_copy_keeps_the_gates_fp32():
    """``params_from_numpy`` carries the stacked ``r`` and gate dicts into
    each group unchanged; ``compute_copy`` casts the products' weights to
    bf16 but leaves ``w_i``, ``w_f`` (weights and biases) and ``r`` in fp32,
    the dtype the reference reads them in."""
    _, jparams, tcfg, tparams = world()
    for g in range(TM.n_groups(tcfg)):
        for kind, names in (("mlstm", ("w_i", "w_f", "up", "down")),
                            ("slstm", ("r", "w_in", "out"))):
            for name in names:
                jt = jparams["groups"][SLOT[kind]][kind][name]
                tt = tparams["groups"][g][SLOT[kind]][kind][name]
                for j, t in zip(jax.tree_util.tree_leaves(jt),
                                tree_leaves(tt)):
                    np.testing.assert_array_equal(np.asarray(j)[g], t.numpy())
    cp = TM.compute_copy(tparams, torch.bfloat16)
    m, s = cp["groups"][1]["slot_0"]["mlstm"], cp["groups"][1]["slot_1"][
        "slstm"]
    for name in ("w_i", "w_f"):
        for leaf in ("w", "b"):
            assert m[name][leaf].dtype == torch.float32
            assert m[name][leaf] is tparams["groups"][1]["slot_0"]["mlstm"][
                name][leaf]
    assert s["r"].dtype == torch.float32
    for t in (m["up"]["w"], m["wq"]["w"], m["down"]["w"], s["w_in"]["w"],
              s["w_in"]["b"], s["out"]["w"], cp["tok_embed"]):
        assert t.dtype == torch.bfloat16
    assert cp["groups"][1]["slot_1"]["norm1"]["scale"].dtype == torch.float32


# -- the layers ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_layer(kind, dtype, with_state):
    jcfg = world(dtype)[0]
    fn = JL.mlstm_apply if kind == "mlstm" else JL.slstm_apply
    if with_state:
        return jax.jit(lambda p, x, st: fn(p, x, jcfg, state=st))
    return jax.jit(lambda p, x: fn(p, x, jcfg))


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["from_zeros", "from_state"])
@pytest.mark.parametrize("s", [13, 77])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_matches_reference(kind, s, with_state):
    """One block of group 1 over (2, S, d) fp32 at S 13 (one chunk of 13)
    and 77 (two chunks of 64, the second padded): the output and the final
    state; from a given state, the one the block leaves after 9 earlier
    steps of another input."""
    jcfg, jparams, tcfg, tparams = world()
    jp = jax.tree.map(lambda a: a[1], jparams["groups"][SLOT[kind]][kind])
    tp = tparams["groups"][1][SLOT[kind]][kind]
    tfn = TL.mlstm_apply if kind == "mlstm" else TL.slstm_apply
    rng = np.random.RandomState(s + 100 * with_state)
    x = rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    if with_state:
        x0 = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
        _, jst = _jit_layer(kind, "float32", False)(jp, jnp.asarray(x0))
        tst = tuple(torch.from_numpy(np.array(a)) for a in jst)
        jo, jst = _jit_layer(kind, "float32", True)(jp, jnp.asarray(x), jst)
        to, tst = tfn(tp, torch.from_numpy(x), tcfg, state=tst)
    else:
        jo, jst = _jit_layer(kind, "float32", False)(jp, jnp.asarray(x))
        to, tst = tfn(tp, torch.from_numpy(x), tcfg)
    close(jo, to, f"{kind} out")
    assert len(tst) == len(STATE[kind])
    for name, a, b in zip(STATE[kind], jst, tst):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        close(a, b, f"{kind} state {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_bf16_matches_reference_rounding(kind):
    """The same block at S 77 with bf16 activations: output and state held
    at the reference's own bf16 error; q and k scaled in bf16 before the
    fp32 recurrence, h back in bf16 before the z gate and ``down``."""
    jcfg, jparams, tcfg, _ = world("bfloat16")
    tparams = world()[3]
    jp = jax.tree.map(lambda a: a[1], jparams["groups"][SLOT[kind]][kind])
    tp = tparams["groups"][1][SLOT[kind]][kind]
    tfn = TL.mlstm_apply if kind == "mlstm" else TL.slstm_apply
    x = np.random.RandomState(7).normal(
        size=(2, 77, tcfg.d_model)).astype(np.float32)
    tier = Tier("bfloat16")
    jo, jst = _jit_layer(kind, "bfloat16", False)(
        jp, jnp.asarray(x, jnp.bfloat16))
    fo, fst = _jit_layer(kind, "float32", False)(jp, jnp.asarray(x))
    to, tst = tfn(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert to.dtype == torch.bfloat16
    tier.check(to, jo, fo, "out")
    for name, a, b, c in zip(STATE[kind], tst, jst, fst):
        assert a.dtype == torch.float32
        tier.check(a, b, c, name)
    tier.finish()


# -- forward, prefill, decode --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_forward(dtype):
    jcfg = world(dtype)[0]
    return jax.jit(lambda p, t: JM.forward(jcfg, p, {"tokens": t},
                                           remat=False)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype):
    """The whole network's logits over (2, 77) tokens: two chunks in each
    mLSTM layer, the second padded; fp32 at the tier, bf16 at the
    reference's own bf16 error."""
    jcfg, jparams, tcfg, _ = world(dtype)
    tparams = world()[3]
    tok = tokens(tcfg, 2, 77, 0)
    jl = _jit_forward(dtype)(jparams, jnp.asarray(tok))
    tl, aux = TM.forward(tcfg, tparams, {"tokens": torch.from_numpy(tok)},
                         remat=False)
    if dtype == "float32":
        close(jl, tl, "logits")
        return
    tier = Tier(dtype)
    tier.check(tl, jl, _jit_forward("float32")(world()[1], jnp.asarray(tok)),
               "logits")
    tier.finish()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_teacher_forced(dtype):
    """Prefill 12 tokens, then 4 decode steps (a scalar position, then
    per-request ones): each step's logits against the port's forward over
    the whole prefix (reference tests/test_decode.py: 2e-4 in fp32, 3e-2
    in bf16), and in fp32 the prefill's cache and every step's logits
    against the reference's."""
    jcfg, jparams, tcfg, _ = world(dtype)
    tparams = world()[3]
    s, extra = 12, 4
    tok = tokens(tcfg, 2, s + extra, 5)
    tol = 2e-4 if dtype == "float32" else 3e-2
    tl0, tc, pos = TM.prefill(tcfg, tparams,
                              {"tokens": torch.from_numpy(tok[:, :s])},
                              cache_len=s + extra)
    assert pos == s
    for sk, names in (("slot_0", ("C", "n")),
                      ("slot_1", ("h", "c", "sn", "m"))):
        assert sorted(tc[sk]) == sorted(names)
    if dtype == "float32":
        jl0, jc, _ = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t},
                                                     s + extra))(
            jparams, jnp.asarray(tok[:, :s]))
        close(jl0, tl0, "prefill logits")
        for sk in tc:
            for name in tc[sk]:
                close(jc[sk][name], tc[sk][name], f"{sk} {name}")
        jdec = jax.jit(lambda p, c, t, q: JM.decode_step(jcfg, p, c, t, q))
    for i in range(extra):
        full, _ = TM.forward(tcfg, tparams,
                             {"tokens": torch.from_numpy(tok[:, :s + i + 1])},
                             remat=False)
        step = torch.from_numpy(tok[:, s + i]).long()
        q = s + i if i == 0 else torch.tensor([s + i, s + i])
        tl, tc = TM.decode_step(tcfg, tparams, tc, step, q)
        np.testing.assert_allclose(_np(tl), _np(full[:, s + i]), rtol=tol,
                                   atol=tol, err_msg=f"decode step {i}")
        if dtype == "float32":
            jl, jc = jdec(jparams, jc, jnp.asarray(tok[:, s + i]),
                          jnp.asarray(np.asarray(q)))
            close(jl, tl, f"decode step {i} against the reference")


# -- serving -------------------------------------------------------------------

def _requests(cfg):
    """(reference, port) request pairs; the third prompt (70 tokens) is
    two mLSTM chunks, the second padded."""
    rng = np.random.RandomState(0)
    out = []
    for ln, nn in ((8, 8), (8, 4), (70, 8), (8, 4)):
        t = rng.randint(0, cfg.vocab_size, size=(ln,)).astype(np.int32)
        out.append((JRequest(tokens=t, gen=JGen(max_new_tokens=nn)),
                    Request(tokens=t, gen=GenerationConfig(
                        max_new_tokens=nn))))
    return out


@functools.lru_cache(maxsize=None)
def _reference_tokens():
    jcfg, jparams, _, _ = world()
    done = JEngine(jcfg, jparams, max_slots=2, decode_block=4).generate(
        [j for j, _ in _requests(jcfg)])
    return [c.tokens for c in done], [c.finish_reason for c in done]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_greedy_engine_tokens_match_reference(paged):
    """Four requests through two slots (slots reused, requests finishing at
    different steps): tokens and finish reasons equal the reference
    engine's; the recurrent states stay slot-resident in the paged pool,
    which pages no block for them."""
    jcfg, _, tcfg, tparams = world()
    eng = Engine(tcfg, tparams, device="cpu", max_slots=2, decode_block=4,
                 paged=paged)
    got = eng.generate([t for _, t in _requests(jcfg)])
    tokens_, reasons = _reference_tokens()
    assert [c.tokens for c in got] == tokens_
    assert [c.finish_reason for c in got] == reasons
    assert tuple(eng._pool.cache["slot_0"]["C"].shape) == (2, 2, 4, 128, 128)
    if paged:
        assert not eng._pool.has_attn and eng._pool.blocks_for_span(99) == 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_staged_engine_matches_joined(paged):
    """The two partitions (a group each; the last unembeds with its frozen
    copy of the tied table) served unjoined give the joined engine's
    tokens, which are the reference's."""
    jcfg, _, tcfg, tparams = world()
    plan = TP.make_plan(tcfg, 2)
    assert TP.stage_param_keys(tcfg, plan, 1) == ["groups", "final_norm",
                                                  "tied_unembed"]
    stages = [TP.slice_stage_params(tcfg, plan, tparams, k) for k in range(2)]
    got = Engine(tcfg, plan=plan, stage_params=stages, device="cpu",
                 max_slots=2, decode_block=4, paged=paged).generate(
        [t for _, t in _requests(jcfg)])
    assert [c.tokens for c in got] == _reference_tokens()[0]


def test_pools_start_as_the_reference_pools():
    """The paged pool's leaves (names, shapes, dtypes, values) equal the
    reference's ``PagedCachePool``'s for the smoke model: zeros but sLSTM's
    stabiliser ``m`` at -1e9; the contiguous pool and ``init_cache`` start
    so too."""
    jcfg, _, tcfg, _ = world()
    got = PagedCachePool(tcfg, 3, 40, device="cpu").cache
    want = JPagedCachePool(jcfg, 3, 40).cache
    assert sorted(got) == sorted(want)
    for sk in want:
        assert sorted(got[sk]) == sorted(want[sk])
        for name, w in want[sk].items():
            g = got[sk][name]
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    contiguous = CachePool(tcfg, 3, 40, device="cpu").cache
    jc = JM.init_cache(jcfg, 3, 40)
    for sk in jc:
        for name, w in jc[sk].items():
            np.testing.assert_array_equal(contiguous[sk][name].numpy(),
                                          np.asarray(w))
    assert float(contiguous["slot_1"]["m"].max()) == -1e9
