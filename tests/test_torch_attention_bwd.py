"""The attention backward: the plain version in the kernels' order
(``ref.flash_attention_bwd``, from the training forward's row
log-sum-exp, ``ref.flash_attention_fwd``) against autograd of
``ref.chunked_attention`` and both against ``jax.grad`` of the reference's
``chunked_attention``, on the CPU; the ``torch.autograd.Function`` of the
kernel branch with ``decide`` monkeypatched to KERNEL and the two CUDA
wrappers stubbed by their plain versions; and, marked ``gpu``, the CUDA
backward against its plain version on the card and two calls bitwise equal.

Tolerances: fp32 2e-5 and bf16 2e-2 (rtol = atol), those of
tests/test_torch_kernels.py.  The same math in another summation order
(fp32), or rounded once to bf16 from fp32 values that agree to ~1e-6.
"""
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

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, Sq, Sk, H, KV, D, causal, window)
CASES = [(2, 40, 40, 4, 2, 64, True, 0),        # GQA 2, D 64, causal
         (1, 24, 56, 6, 1, 64, True, 0),        # Sq < Sk, GQA 6
         (2, 40, 40, 12, 2, 128, True, 16),     # window, GQA 6, D 128
         (1, 32, 32, 4, 2, 128, False, 0)]      # not causal
IDS = ["G2-D64", "SqltSk-G6", "win16-G6-D128", "noncausal-D128"]


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
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for g, w, j in zip(got, want, jgrads):
        _close(_np(g), _np(w), dtype)
        _close(_np(g), np.asarray(j.astype(jnp.float32)), dtype)
    # the forward it reads is the plain forward's, and lse its row lse
    _close(_np(o), _np(TR.chunked_attention(q, k, v, causal=causal,
                                            window=window)), dtype)
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
    tol = "float32" if dtype == "float32" else "bfloat16"
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a.float().cpu().numpy(), w.float().cpu().numpy(), tol)
    _, plain_lse = TR.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    _close(lse.cpu().numpy(), plain_lse.cpu().numpy(), "float32")


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
