"""The kernels' dispatch under grad.  The prefill attention kernel and the
selective scan each have their backward kernel behind a
``torch.autograd.Function`` (``ops._FlashAttention``, ``ops._SelectiveScan``):
an input that requires grad under grad mode goes through it, so the output
has a ``grad_fn`` and the backward wrapper runs.  The ``test_*refuses*``
tests keep the names they had while the dispatch refused such inputs (the
attention's until its backward, the scan's until its); they now hold that
the output has a ``grad_fn`` and that each input's gradient equals the plain
version's autograd.

On the CPU: ``ops.decide`` is monkeypatched to send CPU tensors to the
kernel branch, and the CUDA wrappers to stubs (their plain versions; the
scan's forward-with-states stub saves h0 as its "states", from which the
backward stub computes the plain backward), so the dispatch itself runs
here.  The CPU path's own autograd is held by the plain-path tests
(tests/test_torch_kernels.py, tests/test_torch_selective_scan.py,
tests/test_torch_scan_bwd.py) and the one below.  Tests marked ``gpu`` hold
the check on real CUDA tensors and skip where torch sees no CUDA device.
"""
import jax  # noqa: F401  (the suite's convention: both frameworks at the top)
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.selective_scan import kernel as SK
from repro_torch.kernels.selective_scan import ops as SO
from repro_torch.kernels.selective_scan import ref as SR
from _torch_threads import _one_thread  # noqa: F401


def _attention_inputs(device="cpu"):
    g = torch.Generator(device=device).manual_seed(0)
    return [torch.randn(1, 8, 4, 64, generator=g, device=device)
            for _ in range(3)]


def _scan_inputs(device="cpu", h0=True):
    g = torch.Generator(device=device).manual_seed(0)
    ba, s, di, n = 1, 6, 8, 4
    u = torch.randn(ba, s, di, generator=g, device=device)
    dt = torch.rand(ba, s, di, generator=g, device=device)
    a = -torch.rand(di, n, generator=g, device=device)
    b = torch.randn(ba, s, n, generator=g, device=device)
    c = torch.randn(ba, s, n, generator=g, device=device)
    d = torch.randn(di, generator=g, device=device)
    return [u, dt, a, b, c, d, torch.randn(ba, di, n, generator=g,
                                           device=device) if h0 else None]


@pytest.fixture
def kernel_branch(monkeypatch):
    """Every call of the two ops takes the kernel branch and reaches a stub
    that records it."""
    calls = []

    def attention_stub(q, k, v, *, causal=True, window=0,
                       return_lse=False):
        calls.append("flash_attention")
        out, lse = FR.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
        return (out, lse) if return_lse else out

    def attention_bwd_stub(q, k, v, lse, do, *, causal=True, window=0):
        calls.append("flash_attention_bwd")
        return FR.flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                      window=window)

    def scan_stub(u, dt, A, B, C, D, h0=None):
        calls.append("selective_scan")
        return torch.zeros_like(u), torch.zeros(u.shape[0], u.shape[2],
                                                A.shape[1])

    def scan_saving_stub(u, dt, A, B, C, D, h0=None):
        calls.append("selective_scan_fwd_saving")
        y, h_last = SR.selective_scan(u, dt, A, B, C, D, h0=h0)
        states = torch.zeros_like(h_last) if h0 is None else h0.detach()
        return y, h_last, states

    def scan_bwd_stub(u, dt, A, B, C, D, states, dy, *, dh_last=None,
                      want_dh0=False):
        calls.append("selective_scan_bwd")
        *grads, dh0 = SR.selective_scan_bwd(u, dt, A, B, C, D, dy,
                                            h0=states, dh_last=dh_last)
        return (*grads, dh0 if want_dh0 else None)

    monkeypatch.setattr(FO, "decide", lambda family, t: dispatch.KERNEL)
    monkeypatch.setattr(SO, "decide", lambda family, t: dispatch.KERNEL)
    monkeypatch.setattr(FK, "flash_attention_cuda", attention_stub)
    monkeypatch.setattr(FK, "flash_attention_bwd_cuda", attention_bwd_stub)
    monkeypatch.setattr(SK, "selective_scan_cuda", scan_stub)
    monkeypatch.setattr(SK, "selective_scan_fwd_saving_cuda",
                        scan_saving_stub)
    monkeypatch.setattr(SK, "selective_scan_bwd_cuda", scan_bwd_stub)
    return calls


def _plain_grad(qkv, which):
    x = [t.detach().clone().requires_grad_(i == which)
         for i, t in enumerate(qkv)]
    FR.chunked_attention(*x).sum().backward()
    return x[which].grad


@pytest.mark.parametrize("which", range(3), ids=["q", "k", "v"])
def test_attention_refuses_an_input_that_requires_grad(kernel_branch, which):
    """The kernel branch no longer refuses: its output has a grad_fn, the
    backward wrapper runs, and the input's gradient is the plain one."""
    qkv = _attention_inputs()
    qkv[which].requires_grad_()
    out = FO.flash_attention(*qkv)
    assert out.grad_fn is not None
    out.sum().backward()
    assert kernel_branch == ["flash_attention", "flash_attention_bwd"]
    np.testing.assert_allclose(qkv[which].grad.numpy(),
                               _plain_grad(qkv, which).numpy(), rtol=2e-5,
                               atol=2e-5)
    with torch.no_grad():
        assert FO.flash_attention(*qkv).grad_fn is None
    assert kernel_branch[-1] == "flash_attention"


def _scan_loss(y, h, seed=1):
    """A loss that reads every output element of y and h_last."""
    g = torch.Generator(device=y.device).manual_seed(seed)
    wy = torch.randn(y.shape, generator=g, device=y.device)
    wh = torch.randn(h.shape, generator=g, device=y.device)
    return (y.float() * wy).sum() + (h * wh).sum()


def _plain_scan_grad(args, which):
    x = [None if t is None else t.detach().clone().requires_grad_(i == which)
         for i, t in enumerate(args)]
    y, h = SR.selective_scan(*x[:6], h0=x[6])
    _scan_loss(y, h).backward()
    return x[which].grad


@pytest.mark.parametrize("which", range(7),
                         ids=["u", "dt", "A", "B", "C", "D", "h0"])
def test_scan_refuses_an_input_that_requires_grad(kernel_branch, which):
    """The kernel branch no longer refuses: the forward that saves the tile
    states runs, its outputs have a grad_fn, the backward wrapper runs, and
    the input's gradient is autograd's of ``ref.selective_scan``."""
    *args, h0 = _scan_inputs()
    ins = args + [h0]
    ins[which].requires_grad_()
    y, h = SO.selective_scan(*ins[:6], h0=ins[6])
    assert y.grad_fn is not None and h.grad_fn is not None
    _scan_loss(y, h).backward()
    assert kernel_branch == ["selective_scan_fwd_saving",
                             "selective_scan_bwd"]
    np.testing.assert_allclose(ins[which].grad.numpy(),
                               _plain_scan_grad(ins, which).numpy(),
                               rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        assert SO.selective_scan(*ins[:6], h0=ins[6])[0].grad_fn is None
    assert kernel_branch[-1] == "selective_scan"


def test_inputs_that_need_no_grad_pass_in_grad_mode(kernel_branch):
    """The serve paths: grad mode on, nothing requires grad, no h0."""
    assert torch.is_grad_enabled()
    FO.flash_attention(*_attention_inputs())
    *args, _ = _scan_inputs(h0=False)
    SO.selective_scan(*args)
    assert kernel_branch == ["flash_attention", "selective_scan"]


def test_the_decode_kernels_are_not_guarded(monkeypatch):
    """No path hands a decode a tensor that needs a gradient; their branch
    goes straight to the kernel."""
    seen = []
    monkeypatch.setattr(FO, "decide", lambda family, t: dispatch.KERNEL)
    monkeypatch.setattr(FK, "decode_attention_cuda",
                        lambda *a, **kw: seen.append("decode"))
    q, k, v = _attention_inputs()
    FO.decode_attention(q[:, :1].requires_grad_(), k, v, 3)
    assert seen == ["decode"]


def test_the_cpu_path_keeps_its_autograd():
    qkv = [t.requires_grad_() for t in _attention_inputs()]
    FO.flash_attention(*qkv).sum().backward()
    *args, h0 = _scan_inputs()
    args = [t.requires_grad_() for t in args]
    y, h = SO.selective_scan(*args, h0=h0.requires_grad_())
    (y.sum() + h.sum()).backward()
    for t in qkv + args + [h0]:
        assert t.grad is not None and torch.isfinite(t.grad).all()


# -- the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_attention_refuses_grad_and_runs_without():
    """On the card: an input that requires grad runs the forward kernel and,
    in the backward, the backward kernel (gradients equal the plain ones at
    fp32's 2e-5); without grad the forward alone, bitwise the same."""
    dev = _cuda()
    qkv = _attention_inputs(dev)
    dispatch.LAUNCHES.reset()
    for which in range(3):
        x = [t.detach().clone().requires_grad_(i == which)
             for i, t in enumerate(qkv)]
        out = FO.flash_attention(*x)
        assert out.grad_fn is not None
        out.sum().backward()
        np.testing.assert_allclose(x[which].grad.cpu().numpy(),
                                   _plain_grad(qkv, which).cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        plain_out = FO.flash_attention(*qkv)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("flash_attention") == 4
    assert dispatch.LAUNCHES.get("flash_attention_bwd") == 3
    assert torch.equal(out.detach(), plain_out)


@pytest.mark.gpu
def test_card_scan_refuses_grad_and_runs_without():
    """On the card: an input that requires grad runs the forward kernel that
    saves its tile states and, in the backward, the backward kernel
    (gradients equal the plain ones at fp32's 1e-4 of their largest value:
    the kernels' exponentials are ex2.approx); without grad the forward
    alone, bitwise the same outputs."""
    dev = _cuda()
    *args, h0 = _scan_inputs(dev)
    ins = args + [h0]
    dispatch.LAUNCHES.reset()
    for which in range(len(ins)):
        x = [t.detach().clone().requires_grad_(i == which)
             for i, t in enumerate(ins)]
        y, h = SO.selective_scan(*x[:6], h0=x[6])
        assert y.grad_fn is not None
        _scan_loss(y, h).backward()
        want = _plain_scan_grad(ins, which)
        err = (x[which].grad - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (which, err)
    with torch.no_grad():
        y0, h0_out = SO.selective_scan(*ins[:6], h0=ins[6])
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("selective_scan") == len(ins) + 1
    assert dispatch.LAUNCHES.get("selective_scan_bwd") == len(ins)
    assert torch.equal(y.detach(), y0) and torch.equal(h.detach(), h0_out)
