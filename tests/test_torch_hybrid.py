"""The port's hybrid Mamba/attention stack (Jamba without experts) against
``repro`` on the same weights, on the CPU (with its experts:
tests/test_torch_moe.py).

The world is ``jamba-1.5-large-398b``'s smoke config with ``moe=None``: two
groups of (mamba, attn) slots, each with a dense SwiGLU FFN.  Weights come
from the reference's ``init_params`` and cross through
``repro_torch.convert.params_from_numpy``.  Tolerances are those of
tests/test_torch_model.py: fp32 1e-4 (two frameworks' summation orders),
bf16 5e-2.  Greedy engine tokens must equal ``repro.serve.Engine``'s
(``TokensEqual``) on the contiguous and the paged pool, here and on the
attention-free cut with its experts (``smoke().replace(n_layers=2,
attn_period=8)``: Mamba + MoE, then Mamba + dense), whose pools hold no
attention leaf.
"""
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
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import Engine, GenerationConfig, Request
from repro_torch.serve.kv_cache import (CachePool, PagedCachePool,
                                        place_blocks, place_rows)
from repro_torch.tree import tree_leaves

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def world():
    """(jax cfg, jax params, port cfg, port params) at fp32; ``.replace``
    the configs' dtype for the bf16 tier (the weights stay fp32)."""
    jcfg = jget(ARCH, smoke=True).replace(moe=None, dtype="float32")
    tcfg = tget(ARCH, smoke=True).replace(moe=None, dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sig(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def test_config_matches_reference():
    for smoke in (False, True):
        j, t = jget(ARCH, smoke=smoke), tget(ARCH, smoke=smoke)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "attn_period", "param_dtype", "max_seq"):
            assert getattr(j, f) == getattr(t, f), f
        assert (j.ssm.d_state, j.ssm.d_conv, j.ssm.expand, j.ssm.dt_rank) \
            == (t.ssm.d_state, t.ssm.d_conv, t.ssm.expand, t.ssm.dt_rank)
        assert (j.moe.num_experts, j.moe.top_k, j.moe.every) == \
            (t.moe.num_experts, t.moe.top_k, t.moe.every)
        assert [j.block_kind(l) for l in range(j.n_layers)] == \
            [t.block_kind(l) for l in range(t.n_layers)]
        assert [j.layer_is_moe(l) for l in range(j.n_layers)] == \
            [t.layer_is_moe(l) for l in range(t.n_layers)]
    # the slice served on the card: one attn_period, no experts
    full = tget(ARCH).replace(moe=None, n_layers=8)
    assert TM.slot_spec(full) == [("mamba", False, True)] * 7 + [
        ("attn", False, True)]
    assert TM.n_groups(full) == 1
    assert TL.mamba_dims(full) == (16384, 512, 16, 4)


def test_init_params_tree_shapes_dtypes(world):
    jcfg, jparams, tcfg, want = world
    got = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert _sig(got) == _sig(want)
    assert TM.slot_spec(tcfg) == JM.slot_spec(jcfg) == [
        ("mamba", False, True), ("attn", False, True)]
    assert len(got["groups"]) == JM.n_groups(jcfg) == 2
    m, jm = got["groups"][0]["slot_0"]["mamba"], want["groups"][0][
        "slot_0"]["mamba"]
    for name in ("A_log", "D", "conv_b"):  # deterministic leaves (the
        # two frameworks' log may differ in the last bit)
        torch.testing.assert_close(m[name], jm[name], rtol=1e-6, atol=0)
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    for path in (("in_proj", "w"), ("conv_w",), ("x_proj", "w"),
                 ("dt_proj", "w"), ("out_proj", "w")):
        a, b = m, jm
        for k in path:
            a, b = a[k], b[k]
        assert abs(a.std().item() / b.std().item() - 1) < 0.05, path
    # bf16 storage: A_log and D stay fp32, as in the reference
    bf = TM.init_params(tcfg.replace(param_dtype="bfloat16"),
                        torch.Generator().manual_seed(0))
    jbf = JM.init_params(jcfg.replace(param_dtype="bfloat16"),
                         jax.random.PRNGKey(0))
    assert _sig(bf) == _sig(params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jbf), device="cpu"))


def test_init_params_refuses_experts():
    """The experts themselves are built (``tests/test_torch_moe.py`` holds
    them against the reference); what is refused is the reference's
    ``moe_gather_weights`` sharding constraint, which needs a mesh."""
    for cfg in (tget(ARCH), tget(ARCH, smoke=True)):
        tree = TM.init_params(cfg, torch.Generator(), device="meta")
        slot = tree["groups"][0]["slot_0"]
        e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
        assert slot["moe"]["wg"].shape == (e, d, ff)
        assert slot["moe"]["router"].dtype == torch.float32
        assert "mlp" in tree["groups"][0]["slot_1"]
        with pytest.raises(NotImplementedError, match="step 5"):
            TM.init_params(cfg.replace(moe_gather_weights=True),
                           torch.Generator(), device="meta")


def test_launcher_refuses_experts():
    """The launcher no longer refuses the Jamba smoke's experts: it serves
    them."""
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "3"])


def test_params_from_numpy_round_trip(world):
    jcfg, jparams, tcfg, tparams = world
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        if keys[0] == "groups":
            for g in range(leaf.shape[0]):
                node = tparams["groups"][g]
                for k in keys[1:]:
                    node = node[k]
                assert node.dtype == getattr(torch, leaf.dtype.name)
                np.testing.assert_array_equal(node.numpy(), leaf[g])
        else:
            node = tparams
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), leaf)
    n_leaves = sum(1 for _ in tree_leaves(tparams["groups"]))
    assert n_leaves == 2 * len(jax.tree.leaves(jparams["groups"]))


def test_compute_copy_casts_conv_keeps_a_log_and_d(world):
    _, _, tcfg, tparams = world
    cp = TM.compute_copy(tparams, torch.bfloat16)
    m, pm = cp["groups"][0]["slot_0"]["mamba"], \
        tparams["groups"][0]["slot_0"]["mamba"]
    for name in ("conv_w", "conv_b"):
        assert m[name].dtype == torch.bfloat16
        assert torch.equal(m[name], pm[name].to(torch.bfloat16))
    assert m["in_proj"]["w"].dtype == torch.bfloat16
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    assert m["A_log"] is pm["A_log"] and m["D"] is pm["D"]
    cfg = tcfg.replace(dtype="bfloat16")
    toks = torch.arange(7).reshape(1, 7)
    a, ca, _ = TM.prefill(cfg, tparams, {"tokens": toks}, 10)
    b, cb, _ = TM.prefill(cfg, cp, {"tokens": toks}, 10)
    assert torch.equal(a, b)
    assert torch.equal(ca["slot_0"]["ssm"], cb["slot_0"]["ssm"])


class Tier:
    """Holds the port against the reference on one quantity at a time.

    fp32: the port within atol 1e-4 of the reference, each time.  bf16:
    over all the times one quantity (``what``) is checked, the port's
    distance to the fp32 reference (RMS and largest) is at most 1.5 x (RMS)
    and 2 x (largest) the reference's own bf16 run's, with 5e-2 as the
    least allowed largest distance.  A direct 5e-2 between the two bf16
    runs is below this model's rounding noise: the reference's own bf16
    logits and ssm state move by more than that between its jitted run and
    an op-by-op one (``jax.disable_jit()``), from where bf16 rounds alone,
    and the two packages round at other places still."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.acc = {}

    def check(self, got, want, truth, what):
        g, w = _np(got), _np(want)
        if self.dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                       err_msg=what)
            return
        t = _np(truth)
        a = self.acc.setdefault(what, np.zeros(5))
        a += [((g - t) ** 2).sum(), ((w - t) ** 2).sum(), g.size, 0, 0]
        a[3] = max(a[3], np.abs(g - t).max())
        a[4] = max(a[4], np.abs(w - t).max())

    def finish(self):
        for what, (sp, sr, n, mp, mr) in self.acc.items():
            rp, rr = np.sqrt(sp / n), np.sqrt(sr / n)
            assert rp <= 1.5 * rr, (what, "rms", rp, rr)
            assert mp <= max(5e-2, 2 * mr), (what, "max", mp, mr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_layer_apply_and_decode_match_reference(world, dtype):
    jcfg, jparams, tcfg, tparams = world
    j32 = jcfg
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    xs = rng.normal(size=(3, 2, 1, jcfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tier = Tier(dtype)
    for g in range(2):
        jp = jax.tree.map(lambda a: a[g],
                          jparams["groups"]["slot_0"]["mamba"])
        tp = tparams["groups"][g]["slot_0"]["mamba"]
        jo, jst = JL.mamba_apply(jp, jnp.asarray(x, jdt), jcfg)
        fo, fst = JL.mamba_apply(jp, jnp.asarray(x), j32)
        to, tst = TL.mamba_apply(tp, torch.from_numpy(x).to(tdt), tcfg)
        assert to.dtype == tdt and tst[1].dtype == torch.float32
        assert tst[0].dtype == tdt and tst[0].shape == jst[0].shape
        tier.check(to, jo, fo, "out")
        for name, a, b, c in zip(("conv", "ssm"), tst, jst, fst):
            tier.check(a, b, c, name)
        # from the state: three decode steps, then apply with state=
        pre = (tst, jst, fst)
        for k in range(3):
            jo, jst = JL.mamba_decode(jp, jnp.asarray(xs[k], jdt), jcfg, jst)
            fo, fst = JL.mamba_decode(jp, jnp.asarray(xs[k]), j32, fst)
            to, tst = TL.mamba_decode(tp, torch.from_numpy(xs[k]).to(tdt),
                                      tcfg, tst)
            tier.check(to, jo, fo, "out")
            for name, a, b, c in zip(("conv", "ssm"), tst, jst, fst):
                tier.check(a, b, c, name)
        tst, jst, fst = pre
        jo, _ = JL.mamba_apply(jp, jnp.asarray(x[:, :4], jdt), jcfg,
                               state=jst)
        fo, _ = JL.mamba_apply(jp, jnp.asarray(x[:, :4]), j32, state=fst)
        to, _ = TL.mamba_apply(tp, torch.from_numpy(x[:, :4]).to(tdt), tcfg,
                               state=tst)
        tier.check(to, jo, fo, "out")
    tier.finish()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(world, dtype):
    """Last-token logits and every cache leaf after the prefill and after
    three decode steps with ragged per-request positions."""
    jcfg, jparams, tcfg, tparams = world
    j32 = jcfg
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    cache_len = 24
    batch = {"tokens": jnp.asarray(toks)}
    jl, jc, jpos = JM.prefill(jcfg, jparams, batch, cache_len)
    fl, fc, _ = JM.prefill(j32, jparams, batch, cache_len)
    tl, tc, tpos = TM.prefill(tcfg, tparams,
                              {"tokens": torch.as_tensor(toks).long()},
                              cache_len)
    assert int(jpos) == tpos == 13
    assert _sig(tc) == _sig(jax.tree.map(
        lambda a: torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype))),
        jc))

    tier = Tier(dtype)

    def check_all():
        tier.check(tl, jl, fl, "logits")
        for sk, c in tc.items():
            for n, leaf in c.items():
                tier.check(leaf, jc[sk][n], fc[sk][n], f"{sk}/{n}")

    check_all()
    pos = np.asarray([13, 10], np.int32)
    tok = rng.randint(0, jcfg.vocab_size, size=(2,)).astype(np.int32)
    for step in range(3):
        jt, jp_ = jnp.asarray(tok), jnp.asarray(pos)
        jl, jc = JM.decode_step(jcfg, jparams, jc, jt, jp_)
        fl, fc = JM.decode_step(j32, jparams, fc, jt, jp_)
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.as_tensor(tok).long(),
                                torch.as_tensor(pos))
        check_all()
        tok = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], -1), np.int32)
        pos = pos + 1
    tier.finish()


def test_init_cache_layout_matches_reference(world):
    jcfg, _, tcfg, _ = world
    for dtype in ("float32", "bfloat16"):
        jc = JM.init_cache(jcfg.replace(dtype=dtype), 3, 20)
        tc = TM.init_cache(tcfg.replace(dtype=dtype), 3, 20, device="cpu")
        assert {sk: {n: (tuple(v.shape), str(v.dtype))
                     for n, v in c.items()} for sk, c in jc.items()} == \
            {sk: {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for n, v in c.items()} for sk, c in tc.items()}


def test_cache_constructors_need_a_device(world):
    """A cache never lands on the CPU by omission."""
    _, _, tcfg, _ = world
    with pytest.raises(TypeError):
        TM.init_cache(tcfg, 2, 16)
    with pytest.raises(TypeError):
        CachePool(tcfg, 2, 16)
    with pytest.raises(TypeError):
        PagedCachePool(tcfg, 2, 16)
    assert CachePool(tcfg, 2, 16, device="cpu").cache["slot_0"][
        "ssm"].device.type == "cpu"


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_admission_overwrites_recurrent_state_of_a_reused_slot(world, paged):
    """Mamba leaves stay slot-resident in both pools; admission writes a
    request's conv/ssm rows over whatever the slot held."""
    _, _, tcfg, tparams = world
    toks = torch.arange(9).reshape(1, 9) % tcfg.vocab_size
    _, gc, _ = TM.prefill(tcfg, tparams, {"tokens": toks}, 32)
    if paged:
        pool = PagedCachePool(tcfg, 2, 32, device="cpu")
        assert pool.cache["slot_0"]["conv"].shape == \
            TM.init_cache(tcfg, 2, 32, device="cpu")["slot_0"]["conv"].shape
    else:
        pool = CachePool(tcfg, 2, 32, device="cpu")
    for leaf in tree_leaves(pool.cache):
        leaf.fill_(7.0)                      # a predecessor's stale state
    slots = torch.tensor([1])
    if paged:
        rows = torch.tensor([[1, 2]])
        place_blocks(pool.cache, gc, slots, rows, block_size=16)
    else:
        place_rows(pool.cache, gc, slots)
    for name in ("conv", "ssm"):
        assert torch.equal(pool.cache["slot_0"][name][:, 1],
                           gc["slot_0"][name][:, 0].to(
                               pool.cache["slot_0"][name].dtype))
        assert (pool.cache["slot_0"][name][:, 0] == 7.0).all()


def _requests(cfg, lens=(8, 12, 5, 10, 8), news=(6, 9, 4, 7, 5)):
    rng = np.random.RandomState(0)
    out = []
    for ln, nn in zip(lens, news):
        t = rng.randint(0, cfg.vocab_size, size=(ln,)).astype(np.int32)
        out.append((JRequest(tokens=t, gen=JGen(max_new_tokens=nn)),
                    Request(tokens=t, gen=GenerationConfig(
                        max_new_tokens=nn))))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_greedy_engine_tokens_match_reference(world, paged):
    """Five requests of mixed lengths through two slots, so slots are
    reused: tokens and finish reasons equal the reference engine's."""
    jcfg, jparams, tcfg, tparams = world
    pairs = _requests(jcfg)
    kw = dict(max_slots=2, decode_block=4, paged=paged)
    want = JEngine(jcfg, jparams, **kw).generate([j for j, _ in pairs])
    eng = Engine(tcfg, tparams, device="cpu", **kw)
    got = eng.generate([t for _, t in pairs])
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]
    assert eng.scheduler.max_concurrent == 2 < len(pairs)
    # a request served in a reused slot equals the same request alone
    alone = Engine(tcfg, tparams, device="cpu", **kw).generate(
        [pairs[-1][1]])
    assert alone[0].tokens == got[-1].tokens


# -- the attention-free cut with its experts ---------------------------------

@pytest.fixture(scope="module")
def attention_free():
    """``smoke().replace(n_layers=2, attn_period=8)``: one group of Mamba +
    MoE, then Mamba + dense, with no attention layer (the card's serve cut
    at smoke widths), fp32, the reference's params in both layouts."""
    cut = dict(n_layers=2, attn_period=8, dtype="float32")
    jcfg, tcfg = jget(ARCH, smoke=True).replace(**cut), \
        tget(ARCH, smoke=True).replace(**cut)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_attention_free_engine_tokens_match_reference(attention_free,
                                                      paged):
    """The engine's pools hold no attention leaf (a paged request pins no
    block); five requests through two slots give the reference engine's
    greedy tokens and finish reasons."""
    jcfg, jparams, tcfg, tparams = attention_free
    assert TM.slot_spec(tcfg) == [("mamba", True, True),
                                  ("mamba", False, True)]
    pairs = _requests(jcfg)
    kw = dict(max_slots=2, decode_block=4, paged=paged)
    want = JEngine(jcfg, jparams, **kw).generate([j for j, _ in pairs])
    eng = Engine(tcfg, tparams, device="cpu", **kw)
    got = eng.generate([t for _, t in pairs])
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]
    assert eng.scheduler.max_concurrent == 2 < len(pairs)
    pool = eng._pool
    assert not any("k" in grp for grp in pool.cache.values())
    if paged:
        assert not pool.has_attn and pool.blocks_for_span(64) == 0
