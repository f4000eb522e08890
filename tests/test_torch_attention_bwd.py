"""The attention backward: the plain version in the kernels' order
(``ref.flash_attention_bwd``, from the training forward's row
log-sum-exp, ``ref.flash_attention_fwd``) against autograd of
``ref.chunked_attention`` and both against ``jax.grad`` of the reference's
``chunked_attention``, on the CPU; the same with ``kernel_order=True`` (the
tensor-core kernels' arithmetic: P and dS rounded to the input's type for
their products) against the plain version in fp32 and against fp32
autograd in bf16 at qwen2-1.5b's layer widths; the launch plan of the
tensor-core kernels (``kernel.bwd_plan``); the ``torch.autograd.Function``
of the kernel branch with ``decide`` monkeypatched to KERNEL and the two
CUDA wrappers stubbed by their plain versions; and, marked ``gpu``, the
CUDA backward against both plain versions on the card and two calls
bitwise equal.

Tolerances: fp32 2e-5 and bf16 2e-2 (rtol = atol), those of
tests/test_torch_kernels.py.  The same math in another summation order
(fp32), or rounded once to bf16 from fp32 values that agree to ~1e-6.  At
qwen2's widths bf16 is held as chip_smoke.py holds the card: the largest
error of a gradient row over that row's RMS (floored at the tensor's),
5e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as JR
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as TR
from _torch_threads import _one_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REL_TOL = 5e-2          # chip_smoke.REL_TOL for bf16 / fp16

# (B, Sq, Sk, H, KV, D, causal, window)
CASES = [(2, 40, 40, 4, 2, 64, True, 0),        # GQA 2, D 64, causal
         (1, 24, 56, 6, 1, 64, True, 0),        # Sq < Sk, GQA 6
         (2, 40, 40, 12, 2, 128, True, 16),     # window, GQA 6, D 128
         (1, 32, 32, 4, 2, 128, False, 0),      # not causal
         (2, 40, 40, 4, 4, 80, True, 0),        # MHA, D 80 (stablelm-3b)
         (1, 24, 56, 16, 1, 80, True, 16)]      # GQA 16 (chatglm3-6b), D 80
IDS = ["G2-D64", "SqltSk-G6", "win16-G6-D128", "noncausal-D128", "MHA-D80",
       "win16-G16-D80"]


def _inputs(case, dtype, seed=0):
    b, sq, sk, h, kv, d, _, _ = case
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                        (b, sq, h, d))]
    torch_dt = getattr(torch, dtype)
    return arrays, [torch.from_numpy(a).to(torch_dt) for a in arrays]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _np(t):
    return t.detach().float().numpy()


def _autograd(q, k, v, do, causal, window):
    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = TR.chunked_attention(*qkv, causal=causal, window=window, chunk=16)
    out.backward(do)
    return [t.grad for t in qkv]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd_and_jax(case, dtype):
    *_, causal, window = case
    arrays, (q, k, v, do) = _inputs(case, dtype)
    o, lse = TR.flash_attention_fwd(q, k, v, causal=causal, window=window)
    got = TR.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                 window=window)
    for t in got:
        assert t.dtype == q.dtype
    want = _autograd(q, k, v, do, causal, window)

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrays)

    def loss(q_, k_, v_):
        out = JR.chunked_attention(q_, k_, v_, causal=causal, window=window,
                                   chunk=16)
        return (out.astype(jnp.float32) * jdo.astype(jnp.float32)).sum()
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
    for g, w, j in zip(got, want, jgrads):
        _close(_np(g), _np(w), dtype)
        _close(_np(g), np.asarray(j.astype(jnp.float32)), dtype)
    # the forward it reads is the plain forward's, and the reference's,
    # and lse its row lse
    _close(_np(o), _np(TR.chunked_attention(q, k, v, causal=causal,
                                            window=window)), dtype)
    jfwd = jax.jit(functools.partial(JR.chunked_attention, causal=causal,
                                     window=window))
    _close(_np(o), np.asarray(jfwd(jq, jk, jv).astype(jnp.float32)), dtype)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert lse.dtype == torch.float32 and torch.isfinite(lse).all()


def test_a_row_without_keys_has_lse_minus_inf_and_zero_grads():
    """Queries aligned to the end of fewer keys: the first rows see no key
    under the causal mask; their output, lse and gradients are 0, -inf and
    0, and nothing is NaN."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 64, generator=g)
    k, v = (torch.randn(1, 5, 1, 64, generator=g) for _ in range(2))
    o, lse = TR.flash_attention_fwd(q, k, v, causal=True)
    assert torch.isneginf(lse[0, :, :3]).all() and torch.isfinite(
        lse[0, :, 3:]).all()
    assert (o[0, :3] == 0).all()
    dq, dk, dv = TR.flash_attention_bwd(q, k, v, lse, torch.ones_like(o),
                                        causal=True)
    assert (dq[0, :3] == 0).all()
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()


def grad_row_rel_err(got, want) -> float:
    """chip_smoke.grad_row_rel_err: the largest |error| of a row (last dim)
    over the row's RMS, the RMS floored at the whole tensor's (a gradient
    row can cancel to ~0)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt().clamp_min(
        max(w.pow(2).mean().sqrt().item(), 1e-12))
    return ((g - w).abs().amax(-1) / rms).max().item()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_order_in_fp32_is_the_plain_backward(case):
    *_, causal, window = case
    _, (q, k, v, do) = _inputs(case, "float32", seed=4)
    _, lse = TR.flash_attention_fwd(q, k, v, causal=causal, window=window)
    got = TR.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                 window=window, kernel_order=True)
    want = TR.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                  window=window)
    for g, w in zip(got, want):
        _close(_np(g), _np(w), "float32")


@pytest.mark.parametrize("window", [0, 256], ids=["causal", "window256"])
def test_kernel_order_in_bf16_at_qwen2_widths(window):
    """B1 S1024, 12 query heads over 2 KV heads of 128: the tensor-core
    kernels' rounding against fp32 autograd, and against the plain
    version."""
    case = (1, 1024, 1024, 12, 2, 128, True, window)
    _, (q, k, v, do) = _inputs(case, "bfloat16", seed=5)
    _, lse = TR.flash_attention_fwd(q, k, v, causal=True, window=window)
    got = TR.flash_attention_bwd(q, k, v, lse, do, causal=True,
                                 window=window, kernel_order=True)
    plain = TR.flash_attention_bwd(q, k, v, lse, do, causal=True,
                                   window=window)
    auto = _autograd(*(t.float() for t in (q, k, v, do)), True, window)
    for g, p, a in zip(got, plain, auto):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        assert grad_row_rel_err(g, a) <= REL_TOL
        assert grad_row_rel_err(g, p) <= REL_TOL


# -- the launch plan of the tensor-core kernels ---------------------------------

PLAN_CASES = [(1024, 1024, True, 0), (1024, 1024, True, 256),
              (1024, 1024, False, 0), (100, 200, True, 0),
              (200, 100, True, 0), (130, 130, True, 40),
              (72, 72, False, 20), (300, 300, True, 70),
              # Whisper: the encoder's 1500 frames (1500 = 23 * 64 + 28, a
              # ragged last tile), cross-attention at the decoder's 448
              # tokens against them, and a ragged small case
              (1500, 1500, False, 0), (448, 1500, False, 0),
              (100, 37, False, 0)]


def _valid_pairs(sq, sk, causal, window):
    """{(query tile, key tile)} holding at least one (query, key) pair under
    the forward's mask."""
    mask = TR._prefill_mask(sq, sk, causal, window, "cpu")
    t = FK.BWD_TILE
    return {(i, j) for i in range(-(-sq // t)) for j in range(-(-sk // t))
            if mask[i * t:(i + 1) * t, j * t:(j + 1) * t].any()}


@pytest.mark.parametrize("g", [1, 3, 6, 12, 16])
@pytest.mark.parametrize("sq,sk,causal,window", PLAN_CASES)
def test_bwd_plan_visits_every_masked_pair_once(sq, sk, causal, window, g):
    """The dK/dV blocks visit every (key tile, head, query tile) under the
    mask exactly once, over the warpgroups' head split; the dQ blocks
    compute every (query tile, key tile) under the mask exactly once a
    pass."""
    plan = FK.bwd_plan(sq, sk, 2 * g, 2, causal=causal, window=window)
    valid = _valid_pairs(sq, sk, causal, window)
    heads = sorted(x for wg in plan.heads for x in wg)
    assert heads == list(range(g))
    seen = [(kt, h, qt) for kt, qts in plan.dkdv_blocks
            for wg in plan.heads for h in wg for qt in qts]
    assert len(seen) == len(set(seen))
    assert {(qt, kt) for kt, h, qt in seen} >= valid
    assert {(kt, h, qt) for kt, h, qt in seen
            if (qt, kt) in valid} == {(kt, h, qt) for qt, kt in valid
                                      for h in range(g)}
    computed = [(qb * FK.BWD_DQ_WGS + w, kt) for qb, kts in plan.dq_blocks
                for w in range(FK.BWD_DQ_WGS) for kt in kts
                if not plan.dq_skips(qb * FK.BWD_DQ_WGS + w, kt)]
    assert len(computed) == len(set(computed))
    assert set(computed) >= valid
    assert sorted(kt for kt, _ in plan.dkdv_blocks) == list(
        range(-(-sk // FK.BWD_TILE)))


@pytest.mark.parametrize("sq,sk", [(1500, 1500), (448, 1500), (37, 100)])
def test_bwd_plan_noncausal_walks_every_tile(sq, sk):
    """Without the causal mask (Whisper's encoder and cross-attention) no
    offset Sk - Sq shifts anything: every dQ block walks all the key tiles
    (24 at 1500 keys) and skips none, and every dK/dV block walks all the
    query tiles."""
    plan = FK.bwd_plan(sq, sk, 6, 6, causal=False, window=0)
    nkt, nqt = -(-sk // FK.BWD_TILE), -(-sq // FK.BWD_TILE)
    assert all(list(kts) == list(range(nkt)) for _, kts in plan.dq_blocks)
    assert not any(plan.dq_skips(qt, kt) for qt in range(nqt)
                   for kt in range(nkt))
    assert [list(qts) for _, qts in plan.dkdv_blocks] == \
        [list(range(nqt))] * nkt
    if sk == 1500:
        assert nkt == 24


def test_bwd_plan_launches_the_longest_blocks_first():
    """Under the causal mask at qwen2's train shape the work of the blocks,
    in launch order (blockIdx.y), never grows: the first key tile of a
    group sees every query tile, the last one."""
    plan = FK.bwd_plan(1024, 1024, 12, 2, causal=True, window=0)
    dq = [len(kts) for _, kts in plan.dq_blocks]
    dkdv = [len(qts) for _, qts in plan.dkdv_blocks]
    assert dq == sorted(dq, reverse=True) and dq[0] == 16
    assert dkdv == sorted(dkdv, reverse=True)
    assert dkdv[0] == 16 and dkdv[-1] == 1
    assert [len(h) for h in plan.heads] == [3, 3]


def test_tma_rule_of_the_backward_inputs():
    """What the tensor-core backward reads through tensor maps: a 16-byte
    aligned start and strides of multiples of 16 bytes (a dim of size 1
    is never stepped)."""
    x = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    assert FK._tma_ok(x)
    assert FK._tma_ok(x[:, :, 1:3])                 # 128-byte offset
    assert not FK._tma_ok(x[..., 1:57])             # 2-byte offset
    assert not FK._tma_ok(torch.zeros(2, 8, 4, 68,
                                      dtype=torch.bfloat16)[..., :64])
    assert FK._tma_ok(torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16))
    assert not FK._tma_ok(x.transpose(2, 3))


# -- the autograd.Function of the kernel branch --------------------------------

@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernel branch, with the two CUDA wrappers replaced by their plain
    versions; records the calls."""
    calls = []

    def fwd(q, k, v, *, causal=True, window=0, return_lse=False):
        calls.append("fwd+lse" if return_lse else "fwd")
        out, lse = TR.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
        return (out, lse) if return_lse else out

    def bwd(q, k, v, lse, do, *, causal=True, window=0):
        calls.append("bwd")
        return TR.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                      window=window)

    monkeypatch.setattr(FO, "decide", lambda family, t: dispatch.KERNEL)
    monkeypatch.setattr(FK, "flash_attention_cuda", fwd)
    monkeypatch.setattr(FK, "flash_attention_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_kernel_branch_is_differentiable(plain_kernels, case):
    *_, causal, window = case
    _, (q, k, v, do) = _inputs(case, "float32", seed=1)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FO.flash_attention(*qkv, causal=causal, window=window)
    assert out.grad_fn is not None
    out.backward(do)
    assert plain_kernels == ["fwd+lse", "bwd"]
    for t, w in zip(qkv, _autograd(q, k, v, do, causal, window)):
        _close(_np(t.grad), _np(w), "float32")


def test_kernel_branch_without_grad_is_the_serve_path(plain_kernels):
    _, (q, k, v, _) = _inputs(CASES[0], "float32")
    out = FO.flash_attention(q, k, v)                 # nothing needs grad
    with torch.no_grad():
        FO.flash_attention(q.requires_grad_(), k, v)  # grad mode off
    assert out.grad_fn is None
    assert plain_kernels == ["fwd", "fwd"]


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    """Checks that run before any launch (D 256 has no backward tiles)."""
    q = torch.zeros(1, 4, 2, 256)
    k = torch.zeros(1, 4, 1, 256)
    with pytest.raises(ValueError, match="head dim 256"):
        FK.flash_attention_bwd_cuda(q, k, k, torch.zeros(1, 2, 4), q)
    with pytest.raises(ValueError, match="window"):
        FK.flash_attention_bwd_cuda(q, k, k, torch.zeros(1, 2, 4), q,
                                    window=-1)


# -- the card -------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_card_backward_matches_plain_and_repeats(case, dtype):
    dev = _cuda()
    *_, causal, window = case
    _, ins = _inputs(case, "float32", seed=2)
    q, k, v, do = (t.to(dev, getattr(torch, dtype)) for t in ins)
    _, lse = FK.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    got = FK.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                      window=window)
    again = FK.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    want = TR.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                  window=window)
    order = TR.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                   window=window, kernel_order=True)
    tol = "float32" if dtype == "float32" else "bfloat16"
    for a, b, w, o in zip(got, again, want, order):
        assert torch.equal(a, b)
        _close(a.float().cpu().numpy(), w.float().cpu().numpy(), tol)
        _close(a.float().cpu().numpy(), o.float().cpu().numpy(), tol)
    _, plain_lse = TR.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    _close(lse.cpu().numpy(), plain_lse.cpu().numpy(), "float32")


# Whisper's attention on the card: the encoder's (B8, 1500 frames, 6/6
# heads of 64) and the cross-attention of 448 decoder tokens against them,
# non-causal, in bf16; small ragged non-causal shapes in fp32
WHISPER_CASES = [((8, 1500, 1500, 6, 6, 64), "bfloat16"),
                 ((8, 448, 1500, 6, 6, 64), "bfloat16"),
                 ((2, 100, 100, 2, 2, 64), "float32"),
                 ((2, 37, 100, 2, 2, 64), "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", WHISPER_CASES,
                         ids=["enc-1500", "cross-448x1500", "fp32-100",
                              "fp32-37x100"])
def test_card_backward_whisper_shapes(shape, dtype):
    """The non-causal backward at Whisper's shapes (ragged key and query
    tails) against the plain version and the same in the kernels' order of
    rounding: the largest error within 2e-2 (bf16; fp32 2e-5) of
    max(1, the largest gradient), each gradient row within 5e-2 of its
    RMS (fp32 1e-3); two calls bitwise equal."""
    dev = _cuda()
    b, sq, sk, h, kv, d = shape
    g = torch.Generator(device=dev).manual_seed(7)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(b, sq, h, d, device=dev, generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, sk, kv, d, device=dev, generator=g).to(dt)
            for _ in range(2))
    _, lse = FK.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    got = FK.flash_attention_bwd_cuda(q, k, v, lse, do, causal=False)
    again = FK.flash_attention_bwd_cuda(q, k, v, lse, do, causal=False)
    torch.cuda.synchronize()
    tol, rtol = (TOL[dtype], REL_TOL if dtype != "float32" else 1e-3)
    for want in (TR.flash_attention_bwd(q, k, v, lse, do, causal=False),
                 TR.flash_attention_bwd(q, k, v, lse, do, causal=False,
                                        kernel_order=True)):
        for a, w in zip(got, want):
            scale = max(1.0, w.float().abs().max().item())
            assert (a.float() - w.float()).abs().max().item() <= tol * scale
            assert grad_row_rel_err(a, w) <= rtol
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.gpu
def test_card_ops_backward_equals_plain_autograd():
    dev = _cuda()
    _, ins = _inputs(CASES[2], "float32", seed=3)
    q, k, v, do = (t.to(dev) for t in ins)
    dispatch.LAUNCHES.reset()
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FO.flash_attention(*qkv, window=16)
    out.backward(do)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("flash_attention") == 1
    assert dispatch.LAUNCHES.get("flash_attention_bwd") == 1
    for t, w in zip(qkv, _autograd(q, k, v, do, True, 16)):
        _close(t.grad.cpu().numpy(), w.cpu().numpy(), "float32")
