"""The port's mixture-of-experts FFN (``layers.moe_apply``) and the models
built with it against ``repro`` on the same weights, on the CPU.

Worlds: granite-moe-3b-a800m's smoke config (2 layers, d 256, 4/2 heads of
64, 4 experts of d_ff 128, top 2) and Jamba's smoke config with its experts
(4 layers: Mamba + MoE, attention + dense, twice).  Weights come from the
reference's ``init_params`` through ``repro_torch.convert``; inputs from a
numpy seed.

Routing is held exactly: the expert ids of every token and the keep mask of
every (token, pick) equal the reference's, so the same tokens drop.  Values
at the reference's ``Allclose`` tiers: fp32 rtol 1e-5 with an atol of 1e-5
of the tensor's largest magnitude (a matmul's summation-order error scales
with its output), bf16 2e-2; the whole models' logits and caches as
``test_torch_hybrid.Tier`` holds them (fp32 atol 1e-4; bf16 against the
reference's own distance to fp32).  Serving: tests/test_torch_moe_serve.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.tree import tree_leaves
from repro_torch.verify.compare import Allclose

from test_torch_hybrid import Tier, _sig
from _torch_threads import _one_thread  # noqa: F401

GRANITE = "granite-moe-3b-a800m"
JAMBA = "jamba-1.5-large-398b"
BF16 = Allclose(rtol=2e-2, atol=2e-2)


def _world(arch):
    jcfg = jget(arch, smoke=True).replace(dtype="float32")
    tcfg = tget(arch, smoke=True).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def granite():
    return _world(GRANITE)


@pytest.fixture(scope="module")
def jamba():
    return _world(JAMBA)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(want, got, dtype="float32", what=""):
    want, got = _np(want), _np(got)
    tier = BF16 if dtype == "bfloat16" else Allclose(
        rtol=1e-5, atol=1e-5 * max(float(np.abs(want).max()), 1e-30))
    v = tier.compare(want, got)
    assert v.ok, f"{what}: {v.detail}"


def _moe_leaves(world, g=0):
    jcfg, jparams, tcfg, tparams = world
    jp = jax.tree.map(lambda a: a[g], jparams["groups"]["slot_0"]["moe"])
    return jp, tparams["groups"][g]["slot_0"]["moe"]


def _ref_route(jp, xt, moe_cfg, c):
    """The reference's routing, its own lines of ``_moe_dispatch_one``:
    expert ids (T, K) and the keep mask of the token-major picks (T*K)."""
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, eid = jax.lax.top_k(probs, k)
    flat_e = eid.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(eid), np.asarray(pos_in_e < c)


# -- config -------------------------------------------------------------------

def test_config_matches_reference():
    assert GRANITE in ARCH_NAMES
    for smoke in (False, True):
        j, t = jget(GRANITE, smoke=smoke), tget(GRANITE, smoke=smoke)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "vocab_padded",
                  "tie_embeddings", "norm", "mlp_type", "max_seq",
                  "param_dtype", "dtype", "source", "moe_dispatch_groups",
                  "moe_gather_weights"):
            assert getattr(j, f) == getattr(t, f), f
        for f in ("num_experts", "top_k", "capacity_factor",
                  "router_z_loss", "load_balance_loss", "every"):
            assert getattr(j.moe, f) == getattr(t.moe, f), f
    full = tget(GRANITE)
    assert (full.n_layers, full.d_model, full.hd, full.q_per_kv,
            full.vocab_padded) == (32, 1536, 64, 3, 49280)
    assert TM.slot_spec(full) == [("attn", True, True)]


@pytest.mark.parametrize("tokens", [1, 8, 26, 32, 100, 8192])
def test_moe_capacity_matches_reference(tokens):
    for arch in (GRANITE, JAMBA):
        for smoke in (False, True):
            m = jget(arch, smoke=smoke).moe
            assert TL.moe_capacity(tokens, tget(arch, smoke=smoke).moe) \
                == JL.moe_capacity(tokens, m)
    # granite's training batch (B8 x S1024) and its 8-slot decode
    assert TL.moe_capacity(8192, tget(GRANITE).moe) == 2048
    assert TL.moe_capacity(8, tget(GRANITE).moe) == 8


def test_full_size_tree_counts_the_published_parameters():
    cfg = tget(GRANITE)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    n = sum(t.numel() for t in tree_leaves(params))
    moe = params["groups"][0]["slot_0"]["moe"]
    assert sum(t.numel() for t in moe.values()) == 94_433_280
    assert n == 3_298_985_472
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].shape == (40, 1536, 512)


# -- moe_apply -----------------------------------------------------------------

# (capacity, groups): the default capacity; 8 slots for 26 tokens x 2 picks
# over 4 experts, so picks drop; two dispatch groups of 13 tokens
CASES = {"default": (None, 1), "drops": (8, 1), "groups2": (None, 2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(granite, case, dtype):
    jcfg, _, tcfg, _ = granite
    capacity, groups = CASES[case]
    jp, tp = _moe_leaves(granite)
    x = np.random.default_rng(0).normal(size=(2, 13, jcfg.d_model)) \
        .astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jo, ja = JL.moe_apply(jp, jx, jcfg.moe, capacity=capacity, groups=groups)
    to, ta = TL.moe_apply(tp, tx, tcfg.moe, capacity=capacity, groups=groups)
    assert to.dtype == tx.dtype and to.shape == tx.shape
    _close(jo, to, dtype, "out")
    for name in ("lb_loss", "z_loss"):
        assert ta[name].dtype == torch.float32
        _close(ja[name], ta[name], "float32" if dtype == "float32"
               else dtype, name)
    # routing: ids and keep masks exactly, group by group
    t = 2 * 13
    tg = t // groups
    c = capacity or JL.moe_capacity(tg, jcfg.moe)
    xt = np.asarray(jx).reshape(groups, tg, -1)
    _, _, _, eid, _, keep, counts = TL.moe_route(
        tp["router"], tx.reshape(groups, tg, -1), tcfg.moe, c)
    for g in range(groups):
        want_e, want_keep = _ref_route(jp, jnp.asarray(xt[g]), jcfg.moe, c)
        np.testing.assert_array_equal(eid[g].numpy(), want_e)
        np.testing.assert_array_equal(keep[g].numpy(), want_keep)
        assert counts[g].sum() == tg * jcfg.moe.top_k
    assert bool((~keep).any()) == (case == "drops")


@pytest.mark.parametrize("case", list(CASES))
def test_moe_gradients_match_reference(granite, case):
    """Gradients of sum(out * r) + lb + z in x and in every ``moe`` leaf
    against ``jax.grad``, fp32."""
    jcfg, _, tcfg, _ = granite
    capacity, groups = CASES[case]
    jp, tp = _moe_leaves(granite)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = JL.moe_apply(p, x, jcfg.moe, capacity=capacity,
                                groups=groups)
        return (out * r).sum() + aux["lb_loss"] + aux["z_loss"]
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TL.moe_apply(tp, tx, tcfg.moe, capacity=capacity,
                            groups=groups)
    ((out * torch.from_numpy(r)).sum() + aux["lb_loss"]
     + aux["z_loss"]).backward()
    _close(jgx, tx.grad, what="x")
    assert sorted(tp) == sorted(jgp) == ["router", "wd", "wg", "wu"]
    for k in tp:
        _close(jgp[k], tp[k].grad, what=k)


def test_moe_backward_is_deterministic(granite):
    """Two backward passes give the same grads bit for bit, in bf16 with
    picks dropped: each token's k slot grads are gathered and summed by a
    reshape, never scattered."""
    jcfg, _, tcfg, _ = granite
    _, tp = _moe_leaves(granite)
    x = np.random.default_rng(2).normal(size=(4, 16, jcfg.d_model)) \
        .astype(np.float32)
    grads = []
    for _ in range(2):
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        tx = torch.from_numpy(x).bfloat16().requires_grad_()
        out, aux = TL.moe_apply(p, tx, tcfg.moe, capacity=8, groups=2)
        (out.float().square().sum() + aux["lb_loss"]).backward()
        grads.append([tx.grad] + [p[k].grad for k in sorted(p)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# -- the model -------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, JAMBA])
def test_init_params_tree_matches_reference(arch):
    jcfg, jparams, tcfg, want = _world(arch)
    got = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert _sig(got) == _sig(want)
    assert TM.slot_spec(tcfg) == JM.slot_spec(jcfg)
    m = got["groups"][0]["slot_0"]["moe"]
    # the reference's scales: router and wg/wu 1/sqrt(d), wd 1/sqrt(ff)
    for name, fan in (("router", tcfg.d_model), ("wg", tcfg.d_model),
                      ("wu", tcfg.d_model), ("wd", tcfg.d_ff)):
        assert abs(m[name].std().item() * fan ** 0.5 - 1) < 0.05, name
    bf = TM.init_params(tcfg.replace(param_dtype="bfloat16"),
                        torch.Generator().manual_seed(0))
    mb = bf["groups"][0]["slot_0"]["moe"]
    assert mb["router"].dtype == torch.float32
    assert mb["wg"].dtype == mb["wd"].dtype == torch.bfloat16


def test_params_from_numpy_slices_the_stacked_experts(granite):
    """The reference stacks the experts (G, E, d, ff); group g of the port
    holds its slice, in the reference's dtype."""
    jcfg, jparams, _, tparams = granite
    for g in range(JM.n_groups(jcfg)):
        for name, leaf in jparams["groups"]["slot_0"]["moe"].items():
            got = tparams["groups"][g]["slot_0"]["moe"][name]
            assert str(got.dtype) == f"torch.{leaf.dtype}"
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf[g]))
    assert "mlp" not in tparams["groups"][0]["slot_0"]


def test_compute_copy_casts_experts_keeps_router(granite):
    _, _, tcfg, tparams = granite
    cp = TM.compute_copy(tparams, torch.bfloat16)
    m, pm = cp["groups"][0]["slot_0"]["moe"], \
        tparams["groups"][0]["slot_0"]["moe"]
    for name in ("wg", "wu", "wd"):
        assert m[name].dtype == torch.bfloat16
        assert torch.equal(m[name], pm[name].bfloat16())
    assert m["router"] is pm["router"]
    assert cp["groups"][0]["slot_0"]["attn"]["wq"]["w"].dtype == \
        torch.bfloat16
    cfg = tcfg.replace(dtype="bfloat16")
    toks = torch.arange(7).reshape(1, 7)
    a, _, _ = TM.prefill(cfg, tparams, {"tokens": toks}, 10)
    b, _, _ = TM.prefill(cfg, cp, {"tokens": toks}, 10)
    assert torch.equal(a, b)


def test_gather_weights_is_refused(granite):
    """A sharding constraint with no mesh to gather over on one card."""
    _, _, tcfg, tparams = granite
    cfg = tcfg.replace(moe_gather_weights=True)
    with pytest.raises(NotImplementedError, match="step 5"):
        TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="step 5"):
        TM.forward(cfg, tparams, {"tokens": torch.zeros((1, 4),
                                                        dtype=torch.long)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [GRANITE, JAMBA])
def test_forward_logits_and_aux_match_reference(arch, dtype):
    jcfg, jparams, tcfg, tparams = _world(arch)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 16))
    fl, faux = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jl, jaux = JM.forward(jcfg.replace(dtype=dtype), jparams,
                          {"tokens": jnp.asarray(toks)})
    tl, taux = TM.forward(tcfg.replace(dtype=dtype), tparams,
                          {"tokens": torch.from_numpy(toks)})
    tier = Tier(dtype)
    tier.check(tl, jl, fl, "logits")
    tier.finish()
    for name in ("lb_loss", "z_loss"):
        assert float(taux[name]) > 0
        _close(jaux[name], taux[name], dtype, name)


class _Routes:
    """The expert ids and router probabilities of every routing call of
    both packages, in call order (the reference's through an ordered debug
    callback inside its scan)."""

    def __init__(self, monkeypatch):
        self.on, self.port, self.ref = True, [], []
        route, one = TL.moe_route, JL._moe_dispatch_one

        def port(router, xt, moe_cfg, c):
            res = route(router, xt, moe_cfg, c)
            if self.on:
                self.port.append((res[3][0].numpy().copy(),
                                  res[1][0].detach().numpy().copy()))
            return res

        def ref(p, xt, moe_cfg, c):
            probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], -1)
            jax.debug.callback(self._ref, jax.lax.top_k(probs,
                                                        moe_cfg.top_k)[1],
                               probs, ordered=True)
            return one(p, xt, moe_cfg, c)
        monkeypatch.setattr(TL, "moe_route", port)
        monkeypatch.setattr(JL, "_moe_dispatch_one", ref)

    def _ref(self, eid, probs):
        if self.on:
            self.ref.append((np.asarray(eid), np.asarray(probs)))

    def flips(self):
        """[(call, token, port ids, ref ids, ref probs)] of every token
        whose set of experts differs, oldest call first; the records are
        cleared."""
        jax.effects_barrier()
        assert len(self.port) == len(self.ref) > 0
        out = []
        for n, ((pe, _), (re_, rp)) in enumerate(zip(self.port, self.ref)):
            for i in np.nonzero((np.sort(pe, -1) != np.sort(re_, -1))
                                .any(-1))[0]:
                out.append((n, i, pe[i], re_[i], rp[i]))
        self.port.clear()
        self.ref.clear()
        return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [GRANITE, JAMBA])
def test_prefill_and_decode_match_reference(monkeypatch, arch, dtype):
    """Last-token logits and every cache leaf after the prefill and after
    three decode steps at ragged per-request positions, and every routing
    call's expert ids.

    fp32: the same experts for every token of every call.  bf16: both
    packages round the router's input to 8 bits at other places, so a
    token whose top-k choice is a near tie may pick another expert (the
    reference's own bf16 run flips such tokens against its fp32 run too).
    Every flip of a request's first flipping call must be a near tie in the
    reference's probabilities (the two experts within the bf16 tier, 2e-2);
    later calls carry its consequences.  The requests with no flip are held
    at ``Tier``; the others are left out from their first flip on."""
    jcfg, jparams, tcfg, tparams = _world(arch)
    j32 = jcfg
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    routes = _Routes(monkeypatch)
    rng = np.random.RandomState(0)
    n_req, s = 3, 13
    toks = rng.randint(0, jcfg.vocab_size, size=(n_req, s)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    routes.on = False
    fl, fc, _ = JM.prefill(j32, jparams, batch, 24)
    routes.on = True
    jl, jc, _ = JM.prefill(jcfg, jparams, batch, 24)
    tl, tc, tpos = TM.prefill(tcfg, tparams,
                              {"tokens": torch.as_tensor(toks).long()}, 24)
    assert tpos == s
    tier = Tier(dtype)
    clean = set(range(n_req))

    def check_all(row_of):
        flipped = {}
        for n, i, pe, re_, rp in routes.flips():
            assert dtype == "bfloat16", ("fp32 routing differs", n, i, pe,
                                         re_)
            r = row_of(i)
            if r in clean and flipped.setdefault(r, n) == n:
                for a in set(pe) - set(re_):
                    for b in set(re_) - set(pe):
                        assert abs(rp[a] - rp[b]) <= 2e-2, (n, i, rp)
        clean.difference_update(flipped)
        rows = sorted(clean)
        tier.check(tl[rows], jl[np.asarray(rows, int)],
                   fl[np.asarray(rows, int)], "logits")
        for sk, c in tc.items():
            for name, leaf in c.items():
                tier.check(leaf[:, rows], jc[sk][name][:, rows],
                           fc[sk][name][:, rows], f"{sk}/{name}")

    check_all(lambda i: i // s)
    pos = np.asarray([13, 10, 12], np.int32)
    tok = rng.randint(0, jcfg.vocab_size, size=(n_req,)).astype(np.int32)
    for _ in range(3):
        jt, jp_ = jnp.asarray(tok), jnp.asarray(pos)
        routes.on = False
        fl, fc = JM.decode_step(j32, jparams, fc, jt, jp_)
        routes.on = True
        jl, jc = JM.decode_step(jcfg, jparams, jc, jt, jp_)
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.as_tensor(tok).long(),
                                torch.as_tensor(pos))
        check_all(lambda i: i)
        tok = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], -1), np.int32)
        pos = pos + 1
    assert clean, "every request flipped"
    tier.finish()


@pytest.mark.gpu
def test_moe_on_the_card_equals_cpu_and_repeats_bitwise(granite):
    """On the card: the router routes every token as on the CPU even with
    TF32 on for other matmuls; under the fp32 policy (TF32 off) the layer's
    output and gradients hold the fp32 tier; two bf16 backward passes with
    dropped picks give the same gradients bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jcfg, _, tcfg, _ = granite
    _, tp = _moe_leaves(granite)
    x = np.random.default_rng(3).normal(size=(4, 64, jcfg.d_model)) \
        .astype(np.float32)
    r = torch.from_numpy(np.random.default_rng(4).normal(size=x.shape)
                         .astype(np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        c = TL.moe_capacity(x.shape[0] * x.shape[1], tcfg.moe)
        xt = torch.from_numpy(x).reshape(1, -1, jcfg.d_model)
        want = TL.moe_route(tp["router"], xt, tcfg.moe, c)
        got = TL.moe_route(tp["router"].cuda(), xt.cuda(), tcfg.moe, c)
        for i in (3, 5):                      # expert ids, keep mask
            assert torch.equal(got[i].cpu(), want[i])
        assert torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        grads = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.detach().clone().to(dev).requires_grad_()
                 for k, v in tp.items()}
            tx = torch.from_numpy(x).to(dev).requires_grad_()
            out, aux = TL.moe_apply(p, tx, tcfg.moe)
            ((out * r.to(dev)).sum() + aux["lb_loss"]
             + aux["z_loss"]).backward()
            grads[dev] = [out, tx.grad] + [p[k].grad for k in sorted(p)]
        for a, b in zip(grads["cpu"], grads["cuda"]):
            _close(a, b.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    runs = []
    for _ in range(2):
        p = {k: v.detach().cuda().requires_grad_() for k, v in tp.items()}
        tx = torch.from_numpy(x).cuda().bfloat16().requires_grad_()
        out, aux = TL.moe_apply(p, tx, tcfg.moe, capacity=8, groups=2)
        (out.float().square().sum() + aux["lb_loss"]).backward()
        runs.append([tx.grad] + [p[k].grad for k in sorted(p)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
