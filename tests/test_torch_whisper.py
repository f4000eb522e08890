"""The port's encoder-decoder (whisper-tiny's smoke config: 2 encoder and 2
decoder layers, d 128, 4/4 heads of 32, 64 encoder frames, LayerNorm, the
GELU MLP, learned decoder positions) against ``repro`` on the CPU.

The weights come from the reference's ``init_params`` through
``repro_torch.convert`` (the stacked ``encoder`` unstacked as ``groups``
is); the frames and tokens from a numpy seed, the same arrays in both
packages.  fp32 activations and logits are held at the fp32 tier (rtol
1e-5, atol 1e-5 of the tensor's largest magnitude: a matmul's
summation-order error scales with its output).  Covered: the config and
the full-size tree, the encoder (``encode_audio``), the forward's logits,
prefill then decode logits and the cache's cross leaves
(``tests/test_decode.py``'s whisper case), the stage chain against the
whole forward (``tests/test_pnn.py``'s), greedy engine tokens on both
pools against the reference engine (requests with and without frames),
staged serving against joined, and shared-prefix reuse turned off for an
encoder-decoder in both packages.  On the CPU the attention runs its plain
version in both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import partition as JP
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import Request as JRequest
from repro.serve.kv_cache import PagedCachePool as JPagedCachePool
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import partition as TP
from repro_torch.models import model as TM
from repro_torch.serve import Engine, GenerationConfig, Request
from repro_torch.serve.kv_cache import PagedCachePool
from repro_torch.tree import tree_leaves
from repro_torch.verify.compare import Allclose
from _torch_threads import _one_thread  # noqa: F401

ARCH = "whisper-tiny"
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def world(dtype="float32"):
    """(jax cfg, jax params, port cfg, port params) of the smoke config."""
    jcfg = jget(ARCH, smoke=True).replace(dtype=dtype)
    tcfg = tget(ARCH, smoke=True).replace(dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def frames(cfg, b, seed=0):
    """(b, enc_seq, d) fp32 frames of the stubbed frontend."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, cfg.enc_seq, cfg.d_model) * 0.02).astype(np.float32)


def batch(cfg, b=B, s=S, seed=0):
    """numpy {"tokens", "labels", "frames"}."""
    rng = np.random.RandomState(seed + 1)
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "frames": frames(cfg, b, seed)}


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

def test_config_matches_reference():
    assert ARCH in ARCH_NAMES
    for smoke in (False, True):
        j, t = jget(ARCH, smoke=smoke), tget(ARCH, smoke=smoke)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "vocab_padded", "hd",
                  "norm", "mlp_type", "tie_embeddings", "enc_dec",
                  "enc_layers", "enc_seq", "frontend", "max_seq",
                  "param_dtype", "dtype", "source"):
            assert getattr(j, f) == getattr(t, f), f


def test_full_size_tree_matches_the_reference_shapes():
    """The full config's tree on the meta device: every leaf of the
    reference's (``jax.eval_shape``, its stacked ``groups`` and ``encoder``
    unstacked) with the same shape and dtype, 69.04 M parameters (the
    32,768-row ``dec_pos`` and the untied 384 x 51,968 input and output
    tables among them), head dim 64 at 6/6 heads."""
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
        if k in ("groups", "encoder"):
            n = jax.tree_util.tree_leaves(v)[0].shape[0]
            for g in range(n):
                want.update(flat(jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), v),
                    f"/{k}/{g}"))
        else:
            want.update(flat(v, f"/{k}"))
    assert flat(params) == want
    n = sum(t.numel() for t in tree_leaves(params))
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    assert n == 69_041_664 and (cfg.hd, cfg.q_per_kv) == (64, 1)
    assert sorted(params["groups"][0]["slot_0"]) == [
        "attn", "cross", "mlp", "norm1", "norm2", "norm_x"]


# -- forward, prefill, decode --------------------------------------------------

def test_encoder_and_forward_match_reference():
    jcfg, jparams, tcfg, tparams = world()
    b = batch(jcfg)
    close(jax.jit(lambda p, f: JM.encode_audio(jcfg, p, f))(
              jparams, jnp.asarray(b["frames"])),
          TM.encode_audio(tcfg, tparams, torch.from_numpy(b["frames"])),
          "encode_audio")
    close(JM.sinusoidal(jcfg.enc_seq, jcfg.d_model),
          TM.sinusoidal(tcfg.enc_seq, tcfg.d_model, "cpu"), "sinusoidal")
    jl, _ = jax.jit(lambda p, x: JM.forward(jcfg, p, x, remat=False))(
        jparams, jbatch(b))
    tl, aux = TM.forward(tcfg, tparams, tbatch(b), remat=False)
    close(jl, tl, "forward logits")
    assert aux["n_prefix"] == 0
    assert TM.rope_for(tcfg, torch.arange(4)) is None


def test_prefill_then_decode_matches_reference():
    """The prompt's last logits and two decode steps (a scalar position,
    then a per-request one), the cache's self and cross leaves, and the
    decode logits against the whole forward at the next position."""
    jcfg, jparams, tcfg, tparams = world()
    b = batch(jcfg, s=S + 2, seed=3)
    pre = {k: (v[:, :S] if k == "tokens" else v) for k, v in b.items()
           if k != "labels"}
    jl0, jc, jpos = jax.jit(lambda p, x: JM.prefill(jcfg, p, x, S + 8))(
        jparams, jbatch(pre))
    tl0, tc, tpos = TM.prefill(tcfg, tparams, tbatch(pre), cache_len=S + 8)
    close(jl0, tl0, "prefill logits")
    assert tpos == int(jpos) == S
    assert sorted(tc["slot_0"]) == ["cross_k", "cross_v", "k", "v"]
    for name in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tc["slot_0"][name].shape) == jc["slot_0"][name].shape
        close(jc["slot_0"][name], tc["slot_0"][name], name)
    full, _ = TM.forward(tcfg, tparams, tbatch(b), remat=False)
    for i, pos in enumerate((S, torch.tensor([S + 1, S + 1]))):
        tok = b["tokens"][:, S + i]
        jl, jc = jax.jit(lambda p, c, t, q: JM.decode_step(jcfg, p, c, t, q))(
            jparams, jc, jnp.asarray(tok), jnp.asarray(np.asarray(pos)))
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.from_numpy(tok).long(), pos)
        close(jl, tl, f"decode step {i}")
        close(full[:, S + i], tl, f"decode step {i} against the forward")
        close(jc["slot_0"]["k"], tc["slot_0"]["k"], "self K after decode")


def test_stage_chain_equals_full_forward():
    """``stage_forward`` over 2 stages (stage 0 owns the encoder, the
    payload (x, enc_out) crosses the cut) == the whole forward, and the
    reference's chain."""
    jcfg, jparams, tcfg, tparams = world()
    b = batch(jcfg)
    plan, jplan = TP.make_plan(tcfg, 2), JP.make_plan(jcfg, 2)
    assert TP.stage_param_keys(tcfg, plan, 0) == JP.stage_param_keys(
        jcfg, jplan, 0) == ["groups", "tok_embed", "encoder", "enc_norm",
                            "dec_pos"]
    full, _ = TM.forward(tcfg, tparams, tbatch(b), remat=False)
    x, jx = tbatch(b), jbatch(b)
    for k in range(2):
        sp = TP.slice_stage_params(tcfg, plan, tparams, k)
        jsp = JP.slice_stage_params(jcfg, jplan, jparams, k)
        x, _ = TP.stage_forward(tcfg, plan, k, sp, x, remat=False)
        jx, _ = JP.stage_forward(jcfg, jplan, k, jsp, jx, remat=False)
        if k == 0:
            assert isinstance(x, tuple) and len(x) == 2
            close(jx[0], x[0], "stage 0's boundary")
            close(jx[1], x[1], "stage 0's encoder output")
    torch.testing.assert_close(x, full, rtol=1e-6, atol=1e-6)
    close(jx, x, "chained logits")
    joined = TP.join_stage_params(tcfg, plan, [
        TP.slice_stage_params(tcfg, plan, tparams, k) for k in range(2)])
    assert sorted(joined) == sorted(tparams)


# -- serving -------------------------------------------------------------------

def _requests(cfg, lens=(8, 8, 8, 8), news=(8, 4, 8, 4)):
    """(reference, port) request pairs: each with its own frames but the
    third, which has none (the engine's zero stub)."""
    rng = np.random.RandomState(0)
    out = []
    for i, (ln, nn) in enumerate(zip(lens, news)):
        t = rng.randint(0, cfg.vocab_size, size=(ln,)).astype(np.int32)
        f = None if i == 2 else frames(cfg, 1, seed=10 + i)[0]
        out.append((JRequest(tokens=t, gen=JGen(max_new_tokens=nn),
                             frames=f),
                    Request(tokens=t, gen=GenerationConfig(max_new_tokens=nn),
                            frames=f)))
    return out


@functools.lru_cache(maxsize=None)
def _reference_tokens():
    jcfg, jparams, _, _ = world()
    done = JEngine(jcfg, jparams, max_slots=2, decode_block=4).generate(
        [j for j, _ in _requests(jcfg)])
    return [c.tokens for c in done], [c.finish_reason for c in done]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_greedy_engine_tokens_match_reference(paged):
    """Four requests through two slots (slots reused, requests finishing
    at different steps): tokens and finish reasons equal the reference
    engine's; the cross K/V stay slot-resident in the paged pool."""
    jcfg, _, tcfg, tparams = world()
    eng = Engine(tcfg, tparams, device="cpu", max_slots=2, decode_block=4,
                 paged=paged)
    got = eng.generate([t for _, t in _requests(jcfg)])
    tokens, reasons = _reference_tokens()
    assert [c.tokens for c in got] == tokens
    assert [c.finish_reason for c in got] == reasons
    cross = eng._pool.cache["slot_0"]["cross_k"]
    assert tuple(cross.shape) == (TM.n_groups(tcfg), 2, tcfg.enc_seq,
                                  tcfg.n_kv_heads, tcfg.hd)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_staged_engine_matches_joined(paged):
    """The partitions served unjoined (stage 0 with the encoder, its output
    handed to every stage's cross blocks) give the joined engine's tokens,
    which are the reference's."""
    jcfg, _, tcfg, tparams = world()
    plan = TP.make_plan(tcfg, 2)
    stages = [TP.slice_stage_params(tcfg, plan, tparams, k) for k in range(2)]
    got = Engine(tcfg, plan=plan, stage_params=stages, device="cpu",
                 max_slots=2, decode_block=4, paged=paged).generate(
        [t for _, t in _requests(jcfg)])
    assert [c.tokens for c in got] == _reference_tokens()[0]


def test_shared_prefixes_are_off_for_enc_dec():
    """A request's self-attention K/V depend on its frames, so no prompt
    block is shared, in either package; a decoder-only config shares."""
    jcfg, _, tcfg, _ = world()
    assert not PagedCachePool(tcfg, 2, 32, device="cpu").share_prefixes
    assert not JPagedCachePool(jcfg, 2, 32).share_prefixes
    assert PagedCachePool(tget("qwen2-1.5b", smoke=True), 2, 32,
                          device="cpu").share_prefixes
