"""The port's model (prefill, decode_step, init_params) against
``repro.models.model`` on the same weights, on the CPU.

Weights come from the reference's ``init_params`` and cross through
``repro_torch.convert.params_from_numpy``.  fp32 tolerance 1e-4 covers the
summation order of two frameworks; bf16 logits are held at 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import model as JM
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM


def _worlds(window, dtype):
    jcfg = jget("qwen2-1.5b", smoke=True).replace(dtype=dtype,
                                                  sliding_window=window)
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype=dtype,
                                                  sliding_window=window)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("window", [0, 8], ids=["contiguous", "ring"])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 5e-2)])
def test_prefill_and_decode_match_reference(window, dtype, atol):
    jcfg, jparams, tcfg, tparams = _worlds(window, dtype)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    cache_len = 20
    jl, jc, jpos = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              cache_len)
    tl, tc, tpos = TM.prefill(tcfg, tparams,
                              {"tokens": torch.as_tensor(toks).long()},
                              cache_len)
    assert int(jpos) == tpos == 12
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)
    if dtype == "float32":
        for n in ("k", "v"):
            assert tc["slot_0"][n].shape == jc["slot_0"][n].shape
            np.testing.assert_allclose(_np(tc["slot_0"][n]),
                                       _np(jc["slot_0"][n]), atol=atol)
    # three decode steps with ragged per-request positions
    pos = np.asarray([12, 9], np.int32)
    tok = rng.randint(0, jcfg.vocab_size, size=(2,)).astype(np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.as_tensor(tok).long(),
                                torch.as_tensor(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)
        tok = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], -1), np.int32)
        pos = pos + 1
    if dtype == "float32":
        np.testing.assert_allclose(_np(tc["slot_0"]["k"]),
                                   _np(jc["slot_0"]["k"]), atol=atol)


def test_init_params_tree_shapes_dtypes():
    jcfg = jget("qwen2-1.5b", smoke=True)
    tcfg = tget("qwen2-1.5b", smoke=True)
    want = params_from_numpy(tcfg, jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))))
    got = TM.init_params(tcfg, torch.Generator().manual_seed(0))

    def sig(tree):
        if isinstance(tree, dict):
            return {k: sig(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [sig(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert sig(got) == sig(want)
    assert len(got["groups"]) == JM.n_groups(jcfg) == TM.n_groups(tcfg)
    # the scales of the random init match the reference's
    for path in (("tok_embed",), ("groups", 0, "slot_0", "attn", "wo", "w"),
                 ("groups", 0, "slot_0", "mlp", "wd", "w")):
        a, b = got, want
        for k in path:
            a, b = a[k], b[k]
        assert abs(a.std().item() / b.std().item() - 1) < 0.05


def test_compute_copy_matches_per_op_cast():
    """The engine's one-off compute-dtype weight copy gives the same values
    as the reference's cast at each matmul."""
    _, _, tcfg, tparams = _worlds(0, "bfloat16")
    cp = TM.compute_copy(tparams, torch.bfloat16)
    w = tparams["groups"][0]["slot_0"]["attn"]["wq"]["w"]
    assert cp["groups"][0]["slot_0"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert torch.equal(cp["groups"][0]["slot_0"]["attn"]["wq"]["w"],
                       w.to(torch.bfloat16))
    assert cp["groups"][0]["slot_0"]["norm1"]["scale"].dtype == torch.float32
    assert cp["tok_embed"].dtype == torch.bfloat16
    toks = torch.arange(6).reshape(1, 6)
    a, _, _ = TM.prefill(tcfg, tparams, {"tokens": toks}, 8)
    b, _, _ = TM.prefill(tcfg, cp, {"tokens": toks}, 8)
    assert torch.equal(a, b)


def test_paged_decode_step_matches_reference():
    """decode_step over block-paged pools (the paged write path and the
    block-table read), against the reference on the same pools: a shuffled
    table with a garbage-padded column and ragged positions."""
    jcfg, jparams, tcfg, tparams = _worlds(0, "float32")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    _, jc, _ = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 16)
    bs, lc = 4, 16
    bt = np.asarray([[3, 7, 1, 9, 0], [2, 8, 5, 4, 0]], np.int32)
    pools = {}
    for n in ("k", "v"):
        c = np.asarray(jc["slot_0"][n])                  # (G, B, 16, KV, hd)
        p = np.zeros((c.shape[0], 11, bs) + c.shape[3:], np.float32)
        for b in range(2):
            for j in range(lc // bs):
                p[:, bt[b, j]] = c[:, b, j * bs:(j + 1) * bs]
        pools[n] = p
    jcache = {"slot_0": {n: jnp.asarray(p) for n, p in pools.items()}}
    tcache = {"slot_0": {n: torch.as_tensor(p.copy())
                         for n, p in pools.items()}}
    pos = np.asarray([12, 10], np.int32)
    tok = rng.randint(0, jcfg.vocab_size, size=(2,)).astype(np.int32)
    for _ in range(3):
        jl, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos),
                                    paged=(jnp.asarray(bt), lc))
        tl, tcache = TM.decode_step(tcfg, tparams, tcache,
                                    torch.as_tensor(tok).long(),
                                    torch.as_tensor(pos),
                                    paged=(torch.as_tensor(bt), lc))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)
        tok = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], -1), np.int32)
        pos = pos + 1
    for n in ("k", "v"):       # every block but the garbage block 0
        np.testing.assert_allclose(_np(tcache["slot_0"][n])[:, 1:],
                                   _np(jcache["slot_0"][n])[:, 1:],
                                   atol=1e-4)
