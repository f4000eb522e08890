"""The port's fused SIL-MSE loss against the reference package.

On the CPU: the kernel's plan (``kernel.sil_plan``: every row and unit to
exactly one lane, the grid capped, lanes and unit widths at the paper's,
the LM's and odd shapes) and its 16-byte decision (``kernel.vector_loads``);
``repro_torch.kernels.sil_mse.ops.sil_mse`` (its plain path)
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
from repro_torch.kernels.sil_mse import kernel as TK
from repro_torch.kernels.sil_mse import ops as TO
from repro_torch.kernels.sil_mse import ref as TR
from _torch_threads import _one_thread  # noqa: F401

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


# -- the kernel's plan --------------------------------------------------------

H100_SMS = 132
# (T, d, act bytes an element, 16-byte path) -> (columns a unit, lanes a
# row, units a lane moves in a row): the paper boundary (15 units of 4 fp32,
# half a warp a row), qwen2's LM SIL (192 units of 8 bf16, a warp a row, 6
# a lane), an odd width and the smallest call on the scalar path
PLAN_CASES = {(1410, 60, 4, True): (4, 16, 1),
              (8192, 1536, 2, True): (8, 32, 6),
              (1003, 61, 4, False): (1, 32, 2),
              (1, 1, 4, False): (1, 1, 1),
              (1410, 60, 4, False): (1, 32, 2),
              (8192, 1536, 4, True): (4, 32, 12),
              (5000, 8, 2, True): (8, 1, 1)}


def _coverage(p, t, d):
    """How many times the plan's threads reach each (row, unit), walking
    rows and units as ``sil_mse_kernel`` does."""
    units = d // p.cols
    seen = np.zeros((t, units), np.int64)
    tid = np.arange(TK.THREADS)
    sub, lane = tid // p.lanes, tid % p.lanes
    for b in range(p.blocks):
        row = b * p.rows + sub
        while (row < t).any():
            for u0 in range(0, units, TK.UNITS * p.lanes):
                for k in range(TK.UNITS):
                    u = lane + u0 + k * p.lanes
                    m = (row < t) & (u < units)
                    np.add.at(seen, (row[m], u[m]), 1)
            row = row + p.blocks * p.rows
    return seen


@pytest.mark.parametrize("t,d,item,vector", list(PLAN_CASES),
                         ids=[f"T{t}-d{d}-{item}B-{'vec' if v else 'scalar'}"
                              for t, d, item, v in PLAN_CASES])
@pytest.mark.parametrize("sms", [H100_SMS, 2])
def test_plan_covers_every_row_and_unit_once(t, d, item, vector, sms):
    p = TK.sil_plan(t, d, item, vector, sms)
    assert p.blocks <= TK.BLOCKS_PER_SM * sms
    assert p.rows * p.lanes == TK.THREADS
    assert p.lanes <= 32 and p.lanes & (p.lanes - 1) == 0
    assert p.cols * (d // p.cols) == d
    assert (_coverage(p, t, d) == 1).all()
    assert (p.cols, p.lanes, p.per_lane) == PLAN_CASES[(t, d, item, vector)]
    assert p.vector == vector
    assert 1 << p.lane_shift == p.lanes
    # the rows are spread evenly: no block walks more row groups than
    # ceil(groups / blocks)
    groups = -(-t // p.rows)
    assert p.blocks == -(-groups // -(-groups // p.blocks))


def test_plan_at_the_main_path_shapes():
    """The paper boundary: one pass of 89 blocks; the LM SIL: the grid
    capped at two blocks an SM with four row groups each."""
    paper = TK.sil_plan(1410, 60, 4, True, H100_SMS)
    assert (paper.rows, paper.blocks) == (16, 89)
    lm = TK.sil_plan(8192, 1536, 2, True, H100_SMS)
    assert (lm.rows, lm.blocks) == (8, 256)


def _table(d, m, layout, offset=0, pad=0):
    """A (d, M) fp32 table: "dm" as it is, "md" a view of a contiguous (M,
    d + pad) array from column ``offset`` on."""
    if layout == "dm":
        return torch.rand(d, m)
    return torch.rand(m, d + pad + offset)[:, offset:offset + d].t()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_path_taken_where_aligned(dtype):
    act = torch.randn(1410, 64).to(dtype)
    for a in (act, act[:, :32], torch.randn(1, 64).to(dtype)):
        assert TK.vector_loads(a, _table(a.shape[1], 47, "md"))
    assert TK.vector_loads(act, _table(64, 1, "md"))        # M == 1


@pytest.mark.parametrize("case", [
    "dm table", "act offset", "act row stride", "odd d", "table offset",
    "table column stride", "bf16 d not a multiple of 8"])
def test_vector_path_refused_where_unaligned(case):
    act = torch.randn(300, 60)
    table = _table(60, 47, "md")
    if case == "dm table":
        table = _table(60, 47, "dm")
    elif case == "act offset":
        act = torch.randn(300, 64)[:, 1:61]
    elif case == "act row stride":
        act = torch.randn(300, 62)[:, :60]
    elif case == "odd d":
        act, table = torch.randn(300, 61), _table(61, 47, "md")
    elif case == "table offset":
        table = _table(60, 47, "md", offset=1)
    elif case == "table column stride":
        table = _table(60, 47, "md", pad=2)
    else:
        act = act.bfloat16()
    assert act.stride(1) == 1
    assert not TK.vector_loads(act, table)


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


@pytest.mark.gpu
def test_kernel_one_launch_a_call_by_the_profiler():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.sil_mse.kernel import sil_mse_cuda
    dev = _cuda()
    act, sil, lab = _card_inputs(dev, 1410, 60, 47, torch.float32)
    sil = sil.t().contiguous().t()
    sil_mse_cuda(act, sil, lab)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(256):            # the profiler may drop the first
            torch.cuda._sleep(1)        # kernels of a profile
        for _ in range(20):
            sil_mse_cuda(act, sil, lab)
        torch.cuda.synchronize()
    ours = {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "sil_mse" in e.key}
    assert len(ours) == 1 and sum(ours.values()) == 20, ours


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,m,dtype", [(1410, 60, 47, torch.float32),
                                         (8192, 1536, 151936,
                                          torch.bfloat16)])
def test_kernel_bitwise_over_back_to_back_calls_and_two_streams(t, d, m,
                                                                dtype):
    """The last-block reduction reads every partial: 100 calls in a row and
    calls alternating over two streams give the same bits, and each
    workspace's ticket counter is left at zero."""
    from repro_torch.kernels.sil_mse import kernel as K
    dev = _cuda()
    act, sil, lab = _card_inputs(dev, t, d, m, dtype)
    sil = sil.t().contiguous().t()
    want_loss, want_grad = K.sil_mse_cuda(act, sil, lab)
    torch.cuda.synchronize()
    got = [K.sil_mse_cuda(act, sil, lab) for _ in range(100)]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for i in range(40):
        with torch.cuda.stream(streams[i % 2]):
            got.append(K.sil_mse_cuda(act, sil, lab))
    torch.cuda.synchronize()
    for loss, grad in got:
        assert torch.equal(loss, want_loss) and torch.equal(grad, want_grad)
    for s in streams + [torch.cuda.current_stream(dev)]:
        ws = K._WORKSPACES[(dev.index, s.cuda_stream)]
        assert ws[0].item() == 0
    assert abs(want_loss.item() - TR.sil_mse(act, sil, lab).item()) <= \
        LOSS_TOL[str(dtype)[6:]] * max(1.0, want_loss.item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_vector_and_scalar_paths_match_plain(dtype):
    """The same values through the 16-byte path ((M, d) table, aligned act)
    and the scalar path (the (d, M) table; act one column off its 16-byte
    alignment): both equal the plain version."""
    from repro_torch.kernels.sil_mse import kernel as K
    dev = _cuda()
    act, sil, lab = _card_inputs(dev, 1410, 64, 47, dtype)
    wide = torch.zeros(1410, 72, dtype=dtype, device=dev)
    wide[:, 1:65] = act
    cases = [(act, sil.t().contiguous().t(), True), (act, sil, False),
             (wide[:, 1:65], sil.t().contiguous().t(), False)]
    dn = str(dtype)[6:]
    want = TR.sil_mse(act, sil, lab).item()
    wgrad = TR.sil_mse_grad_act(act, sil, lab)
    for a, table, vector in cases:
        assert K.vector_loads(a, table) == vector
        loss, grad = K.sil_mse_cuda(a, table, lab)
        torch.cuda.synchronize()
        assert abs(loss.item() - want) <= LOSS_TOL[dn] * max(1.0, want)
        torch.testing.assert_close(grad.float(), wgrad,
                                   rtol=GRAD_RTOL[dn], atol=1e-4)
