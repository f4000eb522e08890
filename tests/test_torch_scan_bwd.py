"""The selective scan's gradient in the port against ``jax.vjp`` of the
reference's ``repro.kernels.selective_scan.ref.selective_scan`` (the TPU
kernel has no backward: JAX differentiates its reference through
``lax.associative_scan``), on the CPU.

The plain backward ``ref.selective_scan_bwd`` (the CUDA backward's plain
version), the same in the kernel's order of sums
(``ref.selective_scan_bwd_lanes``) and torch autograd of
``ref.selective_scan`` (the CPU path) are held against it, fp32, on seeded numpy inputs: ragged S (not a multiple
of the kernel's 16-step tile) and ragged Di (not a multiple of its 32
channels), N in {4, 8, 16}, with and without h0 and dh_last.  Tolerance:
each gradient within rtol 1e-4 and 1e-5 of its largest magnitude (the two
packages sum over time, channels and batch in other orders; dA and dD sum
S x Ba terms).  Tests marked ``gpu`` hold the CUDA backward against the
plain one on the card (``chip_smoke.py`` does too, at full width) and skip
where torch sees no CUDA device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import ref as JR
from repro_torch.kernels import dispatch
from repro_torch.kernels.selective_scan import ops as TO
from repro_torch.kernels.selective_scan import ref as TR
from _torch_threads import _one_thread  # noqa: F401

SHAPES = [(2, 37, 40, 4), (1, 50, 33, 8), (2, 21, 70, 16)]
RTOL, ATOL = 1e-4, 1e-5          # ATOL: of the gradient's largest |value|
NAMES = ("du", "ddt", "dA", "dB", "dC", "dD", "dh0")
CASES = [(shape, h0, dh) for shape in SHAPES for h0 in (False, True)
         for dh in (False, True)]
IDS = [f"Ba{s[0]}-S{s[1]}-Di{s[2]}-N{s[3]}{'-h0' * h0}{'-dh_last' * dh}"
       for s, h0, dh in CASES]


def _inputs(ba, s, di, n, h0, dh, seed=0):
    """u, dt (softplus of a normal), A (negative), B, C, D, h0 or None, the
    output cotangent dy and dh_last or None, as numpy fp32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.normal(size=(ba, s, di)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(ba, s, di)))).astype(f)
    a = -np.exp(rng.normal(size=(di, n)) * 0.5).astype(f)
    b = rng.normal(size=(ba, s, n)).astype(f)
    c = rng.normal(size=(ba, s, n)).astype(f)
    d = rng.normal(size=(di,)).astype(f)
    h = rng.normal(size=(ba, di, n)).astype(f) if h0 else None
    dy = rng.normal(size=(ba, s, di)).astype(f)
    dhl = rng.normal(size=(ba, di, n)).astype(f) if dh else None
    return [u, dt, a, b, c, d], h, dy, dhl


def _jax_grads(args, h0, dy, dh_last):
    """jax.vjp of the reference scan at (dy, dh_last or zeros)."""
    def f(*xs):
        ins, h = (xs[:6], xs[6]) if h0 is not None else (xs, None)
        return JR.selective_scan(*ins, h0=h)
    xs = [jnp.asarray(x) for x in args] + (
        [jnp.asarray(h0)] if h0 is not None else [])
    (y, h_last), vjp = jax.vjp(f, *xs)
    ct_h = jnp.zeros_like(h_last) if dh_last is None else jnp.asarray(dh_last)
    grads = vjp((jnp.asarray(dy), ct_h))
    return [np.asarray(g) for g in grads] + (
        [None] if h0 is None else [])


def _t(x):
    return None if x is None else torch.from_numpy(x.copy())


def _assert_grads(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("shape,h0,dh", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(shape, h0, dh):
    args, h, dy, dhl = _inputs(*shape, h0, dh)
    want = _jax_grads(args, h, dy, dhl)
    got = TR.selective_scan_bwd(*[_t(x) for x in args], _t(dy), h0=_t(h),
                                dh_last=_t(dhl))
    _assert_grads(got, want)


@pytest.mark.parametrize("shape,h0,dh", CASES, ids=IDS)
def test_cpu_autograd_matches_jax_vjp(shape, h0, dh):
    """The CPU path of ``ops.selective_scan`` keeps the plain version's own
    autograd; its gradients are the reference's too."""
    args, h, dy, dhl = _inputs(*shape, h0, dh)
    want = _jax_grads(args, h, dy, dhl)
    xs = [_t(x).requires_grad_() for x in args]
    ht = None if h is None else _t(h).requires_grad_()
    y, h_last = TO.selective_scan(*xs, h0=ht)
    loss = (y * _t(dy)).sum()
    if dhl is not None:
        loss = loss + (h_last * _t(dhl)).sum()
    loss.backward()
    _assert_grads([x.grad for x in xs] + [None if ht is None else ht.grad],
                  want)


# the backward kernel's order: a ragged S (two partial sub-tiles) and Di
# (not a whole block of 64 channels), one case a state size
LANE_CASES = [((2, 37, 70, 4), True, True), ((1, 13, 33, 8), False, True),
              ((2, 21, 130, 16), True, False)]


@pytest.mark.parametrize(
    "shape,h0,dh", LANE_CASES,
    ids=[f"Ba{s[0]}-S{s[1]}-Di{s[2]}-N{s[3]}{'-h0' * h0}{'-dh_last' * dh}"
         for s, h0, dh in LANE_CASES])
def test_lane_order_backward_matches_jax_vjp(shape, h0, dh):
    """``ref.selective_scan_bwd_lanes``, the backward in the CUDA kernel's
    order of sums (and exp(dt A) h_{t-1} as h_t - dt u B), is the
    reference's gradient at the fp32 tier."""
    args, h, dy, dhl = _inputs(*shape, h0, dh)
    want = _jax_grads(args, h, dy, dhl)
    got = TR.selective_scan_bwd_lanes(*[_t(x) for x in args], _t(dy),
                                      h0=_t(h), dh_last=_t(dhl))
    _assert_grads(got, want)


def test_plain_backward_of_bf16_u_rounds_du_only():
    """bf16 u: du comes back in u's dtype, the rest in fp32, from the same
    fp32 sums as fp32 u's (so within one bf16 rounding of them)."""
    args, h, dy, _ = _inputs(2, 19, 24, 8, True, False)
    t = [_t(x) for x in args]
    ub = t[0].bfloat16()
    got = TR.selective_scan_bwd(ub, *t[1:], _t(dy).bfloat16(), h0=_t(h))
    ref = TR.selective_scan_bwd(ub.float(), *t[1:], _t(dy).bfloat16().float(),
                                h0=_t(h))
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    assert torch.equal(got[0], ref[0].bfloat16())
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(g, r)


# -- the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,h0,dh", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_card_backward_equals_plain(shape, h0, dh, dtype):
    """The CUDA backward on the states its forward saved against the plain
    backward on the same card tensors: each gradient within 1e-4 of its
    largest magnitude (bf16 u: du within one bf16 ulp, 2^-7 of it), and two
    calls bitwise equal."""
    from repro_torch.kernels.selective_scan import kernel as K
    dev = _cuda()
    args, h, dy, dhl = _inputs(*shape, h0, dh)
    t = [_t(x).to(dev) for x in args]
    t[0] = t[0].to(dtype)
    ht, dyt = (None if h is None else _t(h).to(dev)), _t(dy).to(dev).to(dtype)
    dht = None if dhl is None else _t(dhl).to(dev)
    dispatch.LAUNCHES.reset()
    _, _, states = K.selective_scan_fwd_saving_cuda(*t, h0=ht)
    got = K.selective_scan_bwd_cuda(*t, states, dyt, dh_last=dht,
                                    want_dh0=h0)
    again = K.selective_scan_bwd_cuda(*t, states, dyt, dh_last=dht,
                                      want_dh0=h0)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("selective_scan_bwd") == 2
    want = TR.selective_scan_bwd(*t, dyt, h0=ht, dh_last=dht)
    for name, g, r, w in zip(NAMES, got, again, want):
        if w is None:
            assert g is None and r is None, name
            continue
        assert g.dtype == w.dtype and torch.equal(g, r), name
        tol = 2.0 ** -7 if (name == "du" and dtype == torch.bfloat16) \
            else 1e-4
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), (name, err)
