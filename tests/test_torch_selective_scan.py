"""The port's selective scan against the reference package.

On the CPU: ``repro_torch.kernels.selective_scan`` (its plain path) against
``repro.kernels.selective_scan.ref`` and the Pallas kernel in interpret mode
(``selective_scan_tpu(..., chunk=32, bd=32)``, as
tests/test_kernels.py::test_selective_scan_sweep runs it), on the shapes of
that sweep, at its tolerance: rtol = atol = 1e-4 in fp32.  bf16 u is held
against the fp32 reference at atol 5e-2 (tests/test_precision.py).  Tests
marked ``gpu`` hold the hand-written CUDA kernel against the plain version
on the card and skip where torch sees no CUDA device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import ref as JR
from repro.kernels.selective_scan.kernel import selective_scan_tpu
from repro_torch.kernels import dispatch
from repro_torch.kernels.selective_scan import ops as TO
from repro_torch.kernels.selective_scan import ref as TR

SHAPES = [(2, 64, 32, 8), (1, 100, 64, 16), (2, 256, 128, 16), (1, 33, 48, 4)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(ba, s, di, n, seed=0, h0=False):
    """The same values as numpy arrays: u, dt (softplus of a normal), A
    (negative), B, C, D and optionally a nonzero h0."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(ba, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(ba, s, di)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(di, n)) * 0.5).astype(np.float32)
    b = rng.normal(size=(ba, s, n)).astype(np.float32)
    c = rng.normal(size=(ba, s, n)).astype(np.float32)
    d = rng.normal(size=(di,)).astype(np.float32)
    out = [u, dt, a, b, c, d]
    if h0:
        out.append(rng.normal(size=(ba, di, n)).astype(np.float32))
    return out


def _j(arrays):
    return [jnp.asarray(x) for x in arrays]


def _t(arrays):
    return [torch.from_numpy(x.copy()) for x in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("ba,s,di,n", SHAPES)
def test_plain_matches_reference_and_pallas(ba, s, di, n):
    arrs = _inputs(ba, s, di, n)
    y, h = TO.selective_scan(*_t(arrs))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == (ba, s, di) and h.shape == (ba, di, n)
    ry, rh = JR.selective_scan(*_j(arrs), chunk=32)
    py, ph = selective_scan_tpu(*_j(arrs), chunk=32, bd=32, interpret=True)
    for wy, wh in ((ry, rh), (py, ph)):
        np.testing.assert_allclose(_np(y), _np(wy), **TOL)
        np.testing.assert_allclose(_np(h), _np(wh), **TOL)


@pytest.mark.parametrize("ba,s,di,n", [SHAPES[0], SHAPES[3]])
def test_plain_nonzero_h0_matches_reference(ba, s, di, n):
    *arrs, h0 = _inputs(ba, s, di, n, seed=1, h0=True)
    y, h = TO.selective_scan(*_t(arrs), h0=torch.from_numpy(h0))
    ry, rh = JR.selective_scan(*_j(arrs), chunk=32, h0=jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(ry), **TOL)
    np.testing.assert_allclose(_np(h), _np(rh), **TOL)
    # the state carries: a scan split in two at t = 20 gives the whole one
    tu, tdt, ta, tb, tc, td = _t(arrs)
    th0 = torch.from_numpy(h0)
    y1, h1 = TO.selective_scan(tu[:, :20], tdt[:, :20], ta, tb[:, :20],
                               tc[:, :20], td, h0=th0)
    y2, h2 = TO.selective_scan(tu[:, 20:], tdt[:, 20:], ta, tb[:, 20:],
                               tc[:, 20:], td, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


def test_plain_bf16_u_against_fp32_reference():
    """bf16 u (dt scaled down, as tests/test_precision.py does): y in bf16
    within 5e-2 of the fp32 reference, h_last fp32."""
    u, dt, a, b, c, _ = _inputs(2, 64, 32, 8, seed=2)
    dt = dt * 0.1
    d = np.ones((32,), np.float32)
    arrs = [u, dt, a, b, c, d]
    ry, rh = JR.selective_scan(*_j(arrs))
    tu, *rest = _t(arrs)
    y, h = TO.selective_scan(tu.to(torch.bfloat16), *rest)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(ry), atol=5e-2, rtol=0)
    np.testing.assert_allclose(_np(h), _np(rh), atol=5e-2, rtol=0)
    # and the JAX ref fed the same bf16 u agrees with it at the fp32 tier
    # on the state
    jy, jh = JR.selective_scan(jnp.asarray(u).astype(jnp.bfloat16),
                               *_j(arrs[1:]))
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    np.testing.assert_allclose(_np(y), _np(jy), atol=5e-2, rtol=0)


def test_step_matches_reference_step():
    rng = np.random.default_rng(3)
    ba, di, n = 3, 24, 16
    u = rng.normal(size=(ba, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(ba, di)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(di, n)) * 0.5).astype(np.float32)
    b = rng.normal(size=(ba, n)).astype(np.float32)
    c = rng.normal(size=(ba, n)).astype(np.float32)
    d = rng.normal(size=(di,)).astype(np.float32)
    h = rng.normal(size=(ba, di, n)).astype(np.float32)
    arrs = [u, dt, a, b, c, d, h]
    y, hn = TO.selective_scan_step(*_t(arrs))
    ry, rhn = JR.selective_scan_step(*_j(arrs))
    np.testing.assert_allclose(_np(y), _np(ry), **TOL)
    np.testing.assert_allclose(_np(hn), _np(rhn), **TOL)


def test_loop_of_steps_matches_full_scan():
    """The decode path (one step at a time from the prefill's state) equals
    the full scan, as tests/test_kernels.py::test_selective_scan_step_
    matches_full holds the reference."""
    arrs = _t(_inputs(2, 40, 32, 8, seed=4))
    u, dt, a, b, c, d = arrs
    y, h = TO.selective_scan(u[:, :30], dt[:, :30], a, b[:, :30],
                             c[:, :30], d)
    ys = []
    for t in range(30, 40):
        yt, h = TO.selective_scan_step(u[:, t], dt[:, t], a, b[:, t],
                                       c[:, t], d, h)
        ys.append(yt)
    fy, fh = TO.selective_scan(*arrs)
    torch.testing.assert_close(torch.stack(ys, 1), fy[:, 30:], **TOL)
    torch.testing.assert_close(h, fh, **TOL)
    torch.testing.assert_close(y, fy[:, :30], **TOL)


def test_cpu_tensors_take_the_plain_path():
    arrs = _t(_inputs(1, 8, 16, 4))
    dispatch.LAUNCHES.reset()
    assert dispatch.decide("selective_scan", arrs[0]) == dispatch.PLAIN
    TO.selective_scan(*arrs)
    assert dispatch.LAUNCHES.get("selective_scan") == 0


# -- the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernel)")
    return torch.device("cuda", 0)


def _card(arrs, dev):
    return [torch.from_numpy(x.copy()).to(dev) for x in arrs]


# on the card also: a long prompt, S = 1, S shorter than a time tile, N 4
# and 8 at a Di off the block of channels (100 and 36 are staged by plain
# loads, 104 by 16-byte copies); A is random in every case (_inputs)
GPU_SHAPES = SHAPES + [(2, 512, 1000, 16), (1, 2048, 64, 16), (1, 1, 64, 16),
                       (2, 12, 96, 16), (2, 45, 100, 4), (1, 77, 36, 8),
                       (2, 50, 104, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("ba,s,di,n", GPU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_kernel_matches_plain(ba, s, di, n, dtype, with_h0):
    """chip_smoke.py's tolerances: fp32 1e-4 (rtol and atol); bf16 y within
    one bf16 ulp of the plain's (rtol 2^-7, atol 1e-4: the fp32 values agree
    to ~1e-5 and may round apart), h_last at 1e-4 (both sides read the same
    bf16 u)."""
    from repro_torch.kernels.selective_scan.kernel import \
        selective_scan_cuda
    dev = _cuda()
    arrs = _inputs(ba, s, di, n, seed=5, h0=with_h0)
    u, *rest = _card(arrs, dev)
    h0 = rest.pop() if with_h0 else None
    u = u.to(dtype)
    before = dispatch.LAUNCHES.get("selective_scan")
    y, h = selective_scan_cuda(u, *rest, h0=h0)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("selective_scan") == before + 1
    wy, wh = TR.selective_scan(u, *rest, h0=h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(h, wh, **TOL)
    rtol = TOL["rtol"] if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(y.float(), wy.float(), rtol=rtol, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("ba,s,di,n", [(2, 70, 200, 16), (2, 45, 100, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(ba, s, di, n, dtype):
    """Two calls on the same inputs give the same bits."""
    from repro_torch.kernels.selective_scan.kernel import \
        selective_scan_cuda
    dev = _cuda()
    u, *rest, h0 = _card(_inputs(ba, s, di, n, seed=8, h0=True), dev)
    u = u.to(dtype)
    y1, h1 = selective_scan_cuda(u, *rest, h0=h0)
    y2, h2 = selective_scan_cuda(u, *rest, h0=h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.gpu
def test_kernel_reads_strided_b_c_and_u():
    """B and C as column views of one (Ba, S, R + 2N) tensor, as the Mamba
    layer passes them, and u as a view with a padded row."""
    from repro_torch.kernels.selective_scan.kernel import \
        selective_scan_cuda
    dev = _cuda()
    u, dt, a, b, c, d = _card(_inputs(2, 70, 200, 16, seed=6), dev)
    xdb = torch.randn(2, 70, 24 + 32, device=dev)
    xdb[..., 24:40], xdb[..., 40:] = b, c
    bv, cv = xdb[..., 24:40], xdb[..., 40:]
    wide = torch.zeros(2, 70, 256, device=dev)
    wide[..., :200] = u
    uv = wide[..., :200]
    y, h = selective_scan_cuda(uv, dt, a, bv, cv, d)
    wy, wh = TR.selective_scan(u, dt, a, b, c, d)
    torch.testing.assert_close(y, wy, **TOL)
    torch.testing.assert_close(h, wh, **TOL)


@pytest.mark.gpu
def test_kernel_wrapper_refuses_what_it_does_not_take():
    from repro_torch.kernels.selective_scan.kernel import \
        selective_scan_cuda
    dev = _cuda()
    u, dt, a, b, c, d = _card(_inputs(1, 8, 16, 8), dev)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(u.cpu(), dt.cpu(), a.cpu(), b.cpu(), c.cpu(),
                            d.cpu())
    with pytest.raises(ValueError, match="float32 or"):
        selective_scan_cuda(u.half(), dt, a, b, c, d)
    with pytest.raises(ValueError, match="must be float32"):
        selective_scan_cuda(u, dt.bfloat16(), a, b, c, d)
    with pytest.raises(ValueError, match="N=5"):
        selective_scan_cuda(u, dt, a[:, :5].contiguous(), b[..., :5],
                            c[..., :5], d)
    with pytest.raises(ValueError, match="h0"):
        selective_scan_cuda(u, dt, a, b, c, d,
                            h0=torch.zeros(1, 16, 4, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan_cuda(u.transpose(1, 2).contiguous().transpose(1, 2),
                            dt, a, b, c, d)
    with pytest.raises(ValueError, match="u "):
        selective_scan_cuda(u, dt[:, :4], a, b, c, d)
