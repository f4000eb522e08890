"""The port's fused SIL-MSE loss against the reference package.

On the CPU: ``repro_torch.kernels.sil_mse.ops.sil_mse`` (its plain path)
against ``repro.kernels.sil_mse.ref`` and the Pallas kernel in interpret
mode (``sil_mse_fwd_tpu(..., bt=32, bd=64)``), at the tolerances of
tests/test_kernels.py::test_sil_mse_sweep: loss 1e-5 (fp32) / 5e-2 (bf16)
relative to max(1, loss); grad rtol 1e-5 / 5e-2, atol 1e-4.  The autograd
grad is held against ``jax.grad`` at rtol 1e-5, atol 1e-7, as
tests/test_kernels.py::test_sil_mse_custom_vjp_grad.  Tests marked ``gpu``
hold the hand-written CUDA kernel against the plain version on the card and
skip where torch sees no CUDA device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sil_mse import ref as JR
from repro.kernels.sil_mse import sil_mse as j_sil_mse
from repro.kernels.sil_mse.kernel import sil_mse_fwd_tpu
from repro_torch.kernels import dispatch
from repro_torch.kernels.sil_mse import ops as TO
from repro_torch.kernels.sil_mse import ref as TR

SHAPES = [(64, 128, 47), (100, 96, 512), (256, 512, 1000), (37, 60, 47)]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(t, d, m, dtype, seed=0):
    """(jax act, sil, labels), (torch act, sil, labels) of the same values;
    bf16 act is rounded from the same fp32 numbers by both frameworks."""
    rng = np.random.default_rng(seed)
    act = rng.normal(size=(t, d)).astype(np.float32)
    sil = (rng.uniform(size=(d, m)) * 10).astype(np.float32)
    lab = rng.integers(0, m, size=(t,)).astype(np.int32)
    j = (jnp.asarray(act).astype(dtype), jnp.asarray(sil), jnp.asarray(lab))
    tt = (torch.from_numpy(act).to(getattr(torch, dtype)),
          torch.from_numpy(sil), torch.from_numpy(lab))
    return j, tt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("t,d,m", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_and_pallas(t, d, m, dtype):
    (ja, js, jl), (ta, ts, tl) = _inputs(t, d, m, dtype)
    loss, grad = TO.sil_mse_with_grad(ta, ts, tl)
    assert loss.dtype == torch.float32 and grad.dtype == ta.dtype
    p_loss, p_grad = sil_mse_fwd_tpu(ja, js, jl, bt=32, bd=64,
                                     interpret=True)
    r_loss = JR.sil_mse(ja, js, jl)
    r_grad = JR.sil_mse_grad_act(ja, js, jl)
    tol = LOSS_TOL[dtype]
    for want in (float(p_loss), float(r_loss)):
        assert abs(float(loss) - want) <= tol * max(1.0, want)
    for want in (p_grad, r_grad):
        np.testing.assert_allclose(_f32(grad), _f32(want),
                                   rtol=GRAD_RTOL[dtype], atol=1e-4)
    # the autograd op returns the same loss and saves the same grad
    a = ta.clone().requires_grad_()
    out = TO.sil_mse(a, ts, tl)
    out.backward()
    assert torch.equal(out.detach(), loss)
    assert torch.equal(a.grad, grad)


def test_autograd_matches_jax_grad():
    (ja, js, jl), (ta, ts, tl) = _inputs(40, 24, 10, "float32", seed=1)
    want = jax.grad(lambda a: j_sil_mse(a, js, jl))(ja)
    a = ta.clone().requires_grad_()
    TO.sil_mse(a, ts, tl).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    # and the upstream gradient scales it (g != 1)
    a.grad = None
    (3.0 * TO.sil_mse(a, ts, tl)).backward()
    want3 = jax.grad(lambda a_: 3.0 * j_sil_mse(a_, js, jl))(ja)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want3), rtol=1e-5,
                               atol=1e-7)


def test_frozen_table_and_labels_get_no_grad():
    _, (ta, ts, tl) = _inputs(16, 8, 5, "float32")
    a = ta.clone().requires_grad_()
    s = ts.clone().requires_grad_()
    TO.sil_mse(a, s, tl).backward()
    assert a.grad is not None and s.grad is None


def test_transposed_table_view_gives_the_same_values():
    """The trainer holds the table as a contiguous (M, d) transpose and
    passes its (d, M) view; the plain path reads either layout."""
    _, (ta, ts, tl) = _inputs(37, 60, 47, "float32")
    view = ts.t().contiguous().t()
    assert view.stride() == (1, 60)
    for x, y in zip(TO.sil_mse_with_grad(ta, ts, tl),
                    TO.sil_mse_with_grad(ta, view, tl)):
        assert torch.equal(x, y)


def test_cpu_tensors_take_the_plain_path():
    _, (ta, ts, tl) = _inputs(8, 4, 3, "float32")
    dispatch.LAUNCHES.reset()
    assert dispatch.decide("sil_mse", ta) == dispatch.PLAIN
    TO.sil_mse(ta, ts, tl)
    assert dispatch.LAUNCHES.get("sil_mse") == 0


# -- the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernel)")
    return torch.device("cuda", 0)


def _card_inputs(dev, t, d, m, dtype, labels=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    act = torch.randn(t, d, device=dev, generator=g).to(dtype)
    sil = torch.rand(d, m, device=dev, generator=g) * 10
    lab = torch.randint(0, m, (t,), device=dev, generator=g) \
        if labels is None else labels.to(dev)
    return act, sil, lab


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,m", SHAPES + [(1410, 60, 47), (1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dm", "md"])
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_kernel_matches_plain(t, d, m, dtype, layout, label_dtype):
    from repro_torch.kernels.sil_mse.kernel import sil_mse_cuda
    dev = _cuda()
    act, sil, lab = _card_inputs(dev, t, d, m, dtype)
    lab = lab.to(label_dtype)
    if layout == "md":
        sil = sil.t().contiguous().t()
    before = dispatch.LAUNCHES.get("sil_mse")
    loss, grad = sil_mse_cuda(act, sil, lab)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("sil_mse") == before + 1
    want = TR.sil_mse(act, sil, lab)
    dn = str(dtype).replace("torch.", "")
    assert abs(loss.item() - want.item()) <= LOSS_TOL[dn] * max(
        1.0, want.item())
    torch.testing.assert_close(grad.float(),
                               TR.sil_mse_grad_act(act, sil, lab),
                               rtol=GRAD_RTOL[dn], atol=1e-4)
    assert grad.dtype == dtype


@pytest.mark.gpu
def test_kernel_repeated_labels_strided_rows_and_determinism():
    from repro_torch.kernels.sil_mse.kernel import sil_mse_cuda
    dev = _cuda()
    lab = torch.tensor([3] * 500 + [0, 46] * 100, dtype=torch.int32)
    act, sil, lab = _card_inputs(dev, 700, 60, 47, torch.float32, labels=lab)
    wide = torch.zeros(700, 64, device=dev)
    wide[:, :60] = act
    rows = wide[:, :60]                    # row stride 64, columns contiguous
    got = [sil_mse_cuda(rows, sil, lab) for _ in range(3)]
    torch.cuda.synchronize()
    for loss, grad in got[1:]:             # the same bits every run
        assert torch.equal(loss, got[0][0]) and torch.equal(grad, got[0][1])
    torch.testing.assert_close(got[0][1], TR.sil_mse_grad_act(act, sil, lab),
                               rtol=1e-5, atol=1e-4)
    assert abs(got[0][0].item() - TR.sil_mse(act, sil, lab).item()) <= 1e-5 \
        * max(1.0, TR.sil_mse(act, sil, lab).item())


@pytest.mark.gpu
def test_kernel_autograd_on_the_card():
    dev = _cuda()
    act, sil, lab = _card_inputs(dev, 100, 96, 512, torch.float32)
    a = act.clone().requires_grad_()
    before = dispatch.LAUNCHES.get("sil_mse")
    TO.sil_mse(a, sil, lab).backward()
    assert dispatch.LAUNCHES.get("sil_mse") == before + 1
    torch.testing.assert_close(a.grad, TR.sil_mse_grad_act(act, sil, lab),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_kernel_out_of_range_label_gives_nan_not_a_bad_read():
    from repro_torch.kernels.sil_mse.kernel import sil_mse_cuda
    dev = _cuda()
    act, sil, _ = _card_inputs(dev, 16, 60, 47, torch.float32)
    lab = torch.arange(16, device=dev)
    lab[5] = 47
    loss, grad = sil_mse_cuda(act, sil, lab)
    torch.cuda.synchronize()
    assert torch.isnan(loss)
    assert torch.isnan(grad[5]).all() and torch.isfinite(grad[:5]).all()


@pytest.mark.gpu
def test_kernel_wrapper_refuses_what_it_does_not_take():
    from repro_torch.kernels.sil_mse.kernel import sil_mse_cuda
    dev = _cuda()
    act, sil, lab = _card_inputs(dev, 8, 16, 5, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        sil_mse_cuda(act.cpu(), sil.cpu(), lab.cpu())
    with pytest.raises(ValueError, match="float32 or"):
        sil_mse_cuda(act.half(), sil, lab)
    with pytest.raises(ValueError, match="SIL table must be float32"):
        sil_mse_cuda(act, sil.bfloat16(), lab)
    with pytest.raises(ValueError, match="int32"):
        sil_mse_cuda(act, sil, lab.float())
    with pytest.raises(ValueError, match="columns must be contiguous"):
        sil_mse_cuda(act.t().contiguous().t(), sil, lab)
    with pytest.raises(ValueError, match="act"):
        sil_mse_cuda(act, sil[:8], lab)
    with pytest.raises(ValueError, match="empty"):
        sil_mse_cuda(act[:0], sil, lab[:0])
