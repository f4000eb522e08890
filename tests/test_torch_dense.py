"""The port's LayerNorm and GELU blocks and the dense configs that need
them, against ``repro`` on the CPU.

Blocks: ``layers.norm_apply`` (LayerNorm where the params hold a bias),
``layers.mlp_apply`` (the GELU MLP, ``jax.nn.gelu``'s tanh form; a case
shows that the erf form, ``F.gelu``'s default, would fail the tier) and
``layers.moe_apply`` with GELU experts: outputs, the aux losses and the
gradients at the fp32 tier (rtol 1e-5, atol 1e-5 of the tensor's largest
magnitude: a matmul's summation-order error scales with its output).

Models: the smoke configs of stablelm-3b (LayerNorm, 4/4 heads of 64,
partial rotary), chatglm3-6b (2 KV heads, half rotary, QKV bias),
mistral-large-123b (8/2 heads of 32) and grok-1-314b (4 SwiGLU experts,
top 2), and ``ModelConfig.replace`` variants applied alike to both
packages: stablelm's heads at 80 (d 320: the full model's head dim),
chatglm3's at 16 query heads a KV head (16/1 heads of 16: the full model's
G), stablelm with a GELU MLP and QKV biases, and grok with GELU experts.
Prefill and decode logits at the fp32 tier of tests/test_torch_hybrid.py
(atol 1e-4), on all but the two GELU variants (the block and params tests
hold those).  Greedy engine tokens: tests/test_torch_dense_serve.py; a SIL
stage step and a recovery step: tests/test_torch_dense_train.py.  Weights
come from the reference's ``init_params`` through ``repro_torch.convert``;
inputs from a numpy seed.  On the CPU the attention runs its plain version
in both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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

STABLELM, CHATGLM = "stablelm-3b", "chatglm3-6b"
MISTRAL, GROK = "mistral-large-123b", "grok-1-314b"
ARCHS = [STABLELM, CHATGLM, MISTRAL, GROK]
# name -> (arch, the replace applied to both packages' smoke configs)
WORLDS = {
    "stablelm": (STABLELM, {}),
    "stablelm-d80": (STABLELM, dict(d_model=320)),
    "stablelm-gelu": (STABLELM, dict(mlp_type="gelu", qkv_bias=True)),
    "chatglm3": (CHATGLM, {}),
    "chatglm3-g16": (CHATGLM, dict(n_heads=16, n_kv_heads=1)),
    "mistral": (MISTRAL, {}),
    "grok": (GROK, {}),
    "grok-gelu": (GROK, dict(mlp_type="gelu")),
}


@functools.lru_cache(maxsize=None)
def world(name):
    """(jax cfg, jax params, port cfg, port params) at fp32."""
    arch, kw = WORLDS[name]
    kw = dict(kw, dtype="float32")
    jcfg = jget(arch, smoke=True).replace(**kw)
    tcfg = tget(arch, smoke=True).replace(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(want, got, what=""):
    want, got = _np(want), _np(got)
    v = Allclose(rtol=1e-5, atol=1e-5 * max(float(np.abs(want).max()),
                                            1e-30)).compare(want, got)
    assert v.ok, f"{what}: {v.detail}"


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert arch in ARCH_NAMES
    for smoke in (False, True):
        j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "vocab_padded", "hd",
                  "qkv_bias", "rope_theta", "rope_fraction", "norm",
                  "mlp_type", "tie_embeddings", "max_seq", "param_dtype",
                  "dtype", "source"):
            assert getattr(j, f) == getattr(t, f), f
        assert (j.moe is None) == (t.moe is None)
        if j.moe is not None:
            for f in ("num_experts", "top_k", "capacity_factor",
                      "router_z_loss", "load_balance_loss", "every"):
                assert getattr(j.moe, f) == getattr(t.moe, f), f


@pytest.mark.parametrize("arch,n,hd,g", [(STABLELM, 2_795_443_200, 80, 1),
                                         (CHATGLM, 6_243_584_000, 128, 16),
                                         (MISTRAL, 122_610_069_504, 128, 12)])
def test_full_size_tree_counts_the_published_parameters(arch, n, hd, g):
    """The full configs' trees (on the meta device): parameter counts,
    head dims and query heads a KV head the kernels must take."""
    cfg = tget(arch)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    assert sum(t.numel() for t in tree_leaves(params)) == n
    assert (cfg.hd, cfg.q_per_kv) == (hd, g)
    norm = params["groups"][0]["slot_0"]["norm1"]
    assert sorted(norm) == (["bias", "scale"] if cfg.norm == "layernorm"
                            else ["scale"])


# -- blocks --------------------------------------------------------------------

def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = TL.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 3e-4     # what the tanh form avoids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_apply_matches_reference(kind, dtype):
    """Output and the gradients in x, scale and bias, with a scale and bias
    away from their init and rows far from zero mean (LayerNorm's centring
    is what RMSNorm lacks)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 96)) * 2 + 1.5).astype(np.float32)
    p = {"scale": rng.normal(size=96).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=96).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jo = JL.norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt))
    to = TL.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(tdt))
    assert to.dtype == tdt
    if dtype == "bfloat16":       # one rounding of the same fp32 values
        np.testing.assert_allclose(_np(to), _np(jo), rtol=2e-2, atol=2e-2)
        return
    _close(jo, to, "out")

    def jloss(p, x):
        return (JL.norm_apply(p, x) * r).sum()
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (TL.norm_apply(tp, tx) * torch.from_numpy(r)).sum().backward()
    _close(jgx, tx.grad, "x")
    for k in p:
        _close(jgp[k], tp[k].grad, k)


def _gelu_mlp(rng, d=64, ff=160):
    p = {"w1": {"w": rng.normal(size=(d, ff)) / np.sqrt(d),
                "b": rng.normal(size=ff) * 0.5},
         "w2": {"w": rng.normal(size=(ff, d)) / np.sqrt(ff),
                "b": rng.normal(size=d) * 0.5}}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def test_gelu_mlp_matches_reference_and_catches_erf(monkeypatch):
    """The GELU MLP's output and gradients; the same MLP with the erf form
    is off the tier (pre-activations of a few units, where the two forms
    differ by ~4e-4)."""
    rng = np.random.default_rng(1)
    p = _gelu_mlp(rng)
    x = (rng.normal(size=(2, 9, 64)) * 2).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    jo = JL.mlp_apply(jp, jnp.asarray(x))
    to = TL.mlp_apply(tp, tx)
    _close(jo, to, "out")

    def jloss(p, x):
        return (JL.mlp_apply(p, x) * r).sum()
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    (to * torch.from_numpy(r)).sum().backward()
    _close(jgx, tx.grad, "x")
    for name in ("w1", "w2"):
        for leaf in ("w", "b"):
            _close(jgp[name][leaf], tp[name][leaf].grad, f"{name}/{leaf}")
    monkeypatch.setattr(TL, "gelu", F.gelu)
    erf = TL.mlp_apply(tp, tx)
    v = Allclose(rtol=1e-5, atol=1e-5 * float(np.abs(_np(jo)).max())
                 ).compare(_np(jo), _np(erf))
    assert not v.ok


@pytest.mark.parametrize("capacity", [None, 8], ids=["default", "drops"])
def test_gelu_moe_matches_reference(capacity):
    """The GELU experts (``w1`` (E, d, ff), ``w2`` (E, ff, d)) of grok's
    smoke config with ``mlp_type="gelu"``: output, lb and z, and the
    gradients of sum(out * r) + lb + z in x and every ``moe`` leaf."""
    jcfg, jparams, tcfg, tparams = world("grok-gelu")
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["slot_0"]["moe"])
    tp = tparams["groups"][0]["slot_0"]["moe"]
    assert sorted(tp) == ["router", "w1", "w2"]
    assert tp["w1"].shape == (4, jcfg.d_model, jcfg.d_ff)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = JL.moe_apply(p, x, jcfg.moe, capacity=capacity)
        return (out * r).sum() + aux["lb_loss"] + aux["z_loss"], (out, aux)
    (_, (jo, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TL.moe_apply(tp, tx, tcfg.moe, capacity=capacity)
    _close(jo, out, "out")
    for name in ("lb_loss", "z_loss"):
        _close(jaux[name], aux[name], name)
    ((out * torch.from_numpy(r)).sum() + aux["lb_loss"]
     + aux["z_loss"]).backward()
    _close(jgx, tx.grad, "x")
    for k in tp:
        _close(jgp[k], tp[k].grad, k)


# -- weights carried across, init and the compute copy ------------------------

@pytest.mark.parametrize("name", ["stablelm-gelu", "chatglm3", "grok-gelu"])
def test_params_from_numpy_round_trip(name):
    """Trees with LayerNorm biases, GELU ``w1``/``w2`` dicts with biases,
    QKV biases and GELU experts: every leaf of group g equals the
    reference's slice g in its dtype, and the tree has the port's own
    ``init_params`` signature."""
    jcfg, jparams, tcfg, tparams = world(name)
    assert _sig(TM.init_params(tcfg, torch.Generator().manual_seed(0))) \
        == _sig(tparams)
    assert TM.slot_spec(tcfg) == JM.slot_spec(jcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jparams["groups"])[0]
    for g in range(JM.n_groups(jcfg)):
        for path, leaf in jflat:
            node = tparams["groups"][g]
            for key in path:
                node = node[key.key]
            assert str(node.dtype) == f"torch.{leaf.dtype}"
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf[g]))
    slot = tparams["groups"][0]["slot_0"]
    if jcfg.norm == "layernorm":
        assert sorted(slot["norm1"]) == sorted(tparams["final_norm"]) \
            == ["bias", "scale"]
    if jcfg.qkv_bias:
        assert all("b" in slot["attn"][w] for w in ("wq", "wk", "wv"))
    if "mlp" in slot and jcfg.mlp_type == "gelu":
        assert sorted(slot["mlp"]["w1"]) == ["b", "w"]


@pytest.mark.parametrize("name", ["stablelm-gelu", "grok-gelu"])
def test_compute_copy_casts_gelu_weights_keeps_norms(name):
    """The compute copy casts the GELU MLP's dicts and the raw GELU
    experts; LayerNorm's scale and bias and the router keep their storage
    dtype; a prefill reads the same values either way."""
    _, _, tcfg, tparams = world(name)
    cp = TM.compute_copy(tparams, torch.bfloat16)
    slot, pslot = cp["groups"][0]["slot_0"], tparams["groups"][0]["slot_0"]
    ffn = "moe" if "moe" in slot else "mlp"
    for w in ("w1", "w2"):
        got = slot[ffn][w]["w"] if ffn == "mlp" else slot[ffn][w]
        assert got.dtype == torch.bfloat16
    for k, v in slot["norm1"].items():
        assert v is pslot["norm1"][k]
    if ffn == "moe":
        assert slot["moe"]["router"] is pslot["moe"]["router"]
    cfg = tcfg.replace(dtype="bfloat16")
    toks = torch.arange(7).reshape(1, 7)
    a, _, _ = TM.prefill(cfg, tparams, {"tokens": toks}, 10)
    b, _, _ = TM.prefill(cfg, cp, {"tokens": toks}, 10)
    assert torch.equal(a, b)


# -- prefill, decode and the engine ------------------------------------------

@pytest.mark.parametrize("name", ["stablelm", "stablelm-d80", "chatglm3",
                                  "chatglm3-g16", "mistral", "grok"])
def test_prefill_and_decode_match_reference(name):
    """Last-token logits and every cache leaf after the prefill and after
    three decode steps at ragged per-request positions, fp32 (the
    reference's prefill and decode step jitted once: fewer compiles than
    its eager scans)."""
    jcfg, jparams, tcfg, tparams = world(name)
    jprefill = jax.jit(functools.partial(JM.prefill, jcfg),
                       static_argnums=(2,))
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc, _ = jprefill(jparams, {"tokens": jnp.asarray(toks)}, 24)
    tl, tc, tpos = TM.prefill(tcfg, tparams,
                              {"tokens": torch.as_tensor(toks).long()}, 24)
    assert tpos == 13
    tier = Tier("float32")

    def check_all():
        tier.check(tl, jl, jl, "logits")
        for sk, c in tc.items():
            for n, leaf in c.items():
                tier.check(leaf, jc[sk][n], jc[sk][n], f"{sk}/{n}")

    check_all()
    pos = np.asarray([13, 10], np.int32)
    tok = rng.randint(0, jcfg.vocab_size, size=(2,)).astype(np.int32)
    for _ in range(3):
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.as_tensor(tok).long(),
                                torch.as_tensor(pos))
        check_all()
        tok = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], -1), np.int32)
        pos = pos + 1
