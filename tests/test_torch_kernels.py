"""The port's attention against the reference package on the same arrays.

On the CPU: the port's plain versions (``repro_torch.kernels.flash_attention.ref``)
against ``repro.kernels.flash_attention.ref`` and the Pallas kernels in
interpret mode, at fp32 2e-5 / bf16 2e-2 (the tolerances of
tests/test_kernels.py), plus the CPU dispatch.  Tests marked ``gpu`` hold
the hand-written CUDA kernels against the plain versions on the card and
skip where torch sees no CUDA device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as JK
from repro.kernels.flash_attention import ref as JR
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as TO
from repro_torch.kernels.flash_attention import ref as TR
from _torch_threads import _one_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    """One numpy array as a (jax, torch) pair of the same values."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.as_tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _qkv(rng, b, sq, sk, h, kv, d, dtype):
    q = rng.normal(size=(b, sq, h, d))
    k = rng.normal(size=(b, sk, kv, d))
    v = rng.normal(size=(b, sk, kv, d))
    return [_pair(x, dtype) for x in (q, k, v)]


# -- prefill ---------------------------------------------------------------

@pytest.mark.parametrize("h,kv,d", [(4, 2, 32), (12, 2, 128)],
                         ids=["G2-D32", "G6-D128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
def test_prefill_plain_matches_reference(h, kv, d, dtype, window):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 40, 40, h, kv, d, dtype)
    tol = TOL[dtype]
    want_ref = JR.chunked_attention(jq, jk, jv, window=window, chunk=16)
    want_pallas = JK.flash_attention_tpu(jq, jk, jv, window=window,
                                         interpret=True)
    got = TR.chunked_attention(tq, tk, tv, window=window, chunk=16)
    _close(got, want_ref, tol)
    _close(got, want_pallas, tol)
    _close(TR.naive_attention(tq, tk, tv, window=window), want_ref, tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_prefill_short_queries_align_to_key_end(causal, window):
    """Sq < Sk: queries sit at the end of the keys, as the reference's ref
    (not the Pallas kernel's unshifted mask) says."""
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 24, 40, 12, 2, 128,
                                        "float32")
    want = JR.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                chunk=16)
    _close(TR.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                chunk=16), want, TOL["float32"])
    _close(TR.naive_attention(tq, tk, tv, causal=causal, window=window),
           JR.naive_attention(jq, jk, jv, causal=causal, window=window),
           TOL["float32"])


def test_prefill_fully_masked_rows_are_zero():
    """Sq > Sk: the first rows see no key; both packages return 0."""
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 12, 8, 4, 2, 32, "float32")
    got = TR.chunked_attention(tq, tk, tv, chunk=4)
    want = JR.chunked_attention(jq, jk, jv, chunk=4)
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got[:, :4]) == 0
    _close(got, want, TOL["float32"])


# -- decode ----------------------------------------------------------------

@pytest.mark.parametrize("h,kv,d", [(4, 2, 32), (12, 2, 128)],
                         ids=["G2-D32", "G6-D128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference(h, kv, d, dtype):
    rng = np.random.default_rng(3)
    b, lc = 4, 40
    (jq, tq), (jk, tk), (jv, tv) = [
        _pair(rng.normal(size=s), dtype)
        for s in ((b, 1, h, d), (b, lc, kv, d), (b, lc, kv, d))]
    tol = TOL[dtype]
    # partial cache, ragged batch (one request past the ring length), all
    for pos in (lc // 2, np.asarray([0, 17, 39, 55], np.int32), 2 * lc):
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.as_tensor(pos)
        got = TR.decode_attention(tq, tk, tv, tpos)
        _close(got, JR.decode_attention(jq, jk, jv, jpos), tol)
        _close(got, JK.decode_attention_tpu(jq, jk, jv, jpos, bk=16), tol)


@pytest.mark.parametrize("window", [0, 24])
def test_paged_plain_matches_reference(window):
    rng = np.random.default_rng(4)
    b, h, kv, d, bs, nb, n_blocks = 3, 12, 2, 128, 16, 3, 12
    lc = 40 if not window else window
    (jq, tq), (jk, tk), (jv, tv) = [
        _pair(rng.normal(size=s), "float32")
        for s in ((b, 1, h, d), (n_blocks, bs, kv, d),
                  (n_blocks, bs, kv, d))]
    # distinct shuffled physical blocks; the last request only owns two,
    # its third entry points at the garbage block 0
    ids = rng.permutation(np.arange(1, n_blocks))[:b * nb].reshape(b, nb)
    ids[2, 2] = 0
    pos = np.asarray([5, 39, 30], np.int32)
    nbk = -(-lc // bs)
    bt = ids[:, :nbk].astype(np.int32)
    got = TR.paged_decode_attention(tq, tk, tv, torch.as_tensor(bt),
                                    torch.as_tensor(pos), logical_len=lc,
                                    window=window)
    want = JR.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                     jnp.asarray(pos), logical_len=lc,
                                     window=window)
    want_pallas = JK.paged_decode_attention_tpu(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(pos), logical_len=lc,
        window=window, interpret=True)
    _close(got, want, TOL["float32"])
    _close(got, want_pallas, TOL["float32"])


# -- dispatch ----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path():
    dispatch.LAUNCHES.reset()
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.normal(size=(1, 8, 4, 32)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(1, 8, 2, 32)), dtype=torch.float32)
    assert dispatch.decide("flash_attention", q) == dispatch.PLAIN
    out = TO.flash_attention(q, k, k)
    assert torch.equal(out, TR.chunked_attention(q, k, k))
    TO.decode_attention(q[:, :1], k, k, 3)
    TO.paged_decode_attention(q[:, :1], k[0].reshape(2, 4, 2, 32), k[0]
                              .reshape(2, 4, 2, 32),
                              torch.tensor([[0, 1]]), 5, logical_len=8)
    assert dispatch.LAUNCHES.snapshot() == {}
    with pytest.raises(ValueError):
        dispatch.decide("flash_attention", q.to("meta"))


# -- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,window", [(200, 200, 0), (200, 200, 64),
                                          (72, 200, 0)])
def test_prefill_kernel_matches_plain(dtype, sq, sk, window):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, sq, 12, 128, device=dev, generator=g).to(dtype)
    k = torch.randn(2, sk, 2, 128, device=dev, generator=g).to(dtype)
    v = torch.randn(2, sk, 2, 128, device=dev, generator=g).to(dtype)
    dispatch.LAUNCHES.reset()
    got = TO.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("flash_attention") == 1
    want = TR.chunked_attention(q, k, v, window=window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_match_plain_and_each_other(dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, kv, d, lc, bs = 4, 12, 2, 128, 72, 16
    nb = -(-lc // bs)
    q = torch.randn(b, 1, h, d, device=dev, generator=g).to(dtype)
    n_blocks = b * nb + 1
    kp = torch.randn(n_blocks, bs, kv, d, device=dev, generator=g).to(dtype)
    vp = torch.randn(n_blocks, bs, kv, d, device=dev, generator=g).to(dtype)
    bt = (torch.randperm(n_blocks - 1, generator=torch.Generator()
                         .manual_seed(0)) + 1)[:b * nb].reshape(b, nb)
    bt = bt.to(torch.int32).to(dev)
    pos = torch.tensor([3, 40, 71, 200], dtype=torch.int32, device=dev)
    kc = kp[bt.long()].reshape(b, nb * bs, kv, d)[:, :lc].contiguous()
    vc = vp[bt.long()].reshape(b, nb * bs, kv, d)[:, :lc].contiguous()
    got_c = TO.decode_attention(q, kc, vc, pos)
    got_p = TO.paged_decode_attention(q, kp, vp, bt, pos, logical_len=lc)
    torch.cuda.synchronize()
    want = TR.decode_attention(q, kc, vc, pos)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got_c.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(got_c, got_p)      # same tiles, same float order


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,kv", [(64, 8, 8), (256, 8, 1), (128, 16, 2)],
                         ids=["D64-G1", "D256-G8", "D128-G8"])
@pytest.mark.parametrize("sq,sk,causal", [(1, 1, True), (65, 65, True),
                                          (63, 130, True), (40, 90, False)])
def test_prefill_kernel_other_shapes(d, h, kv, sq, sk, causal):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(3, sq, h, d, device=dev, generator=g).half()
    k = torch.randn(3, sk, kv, d, device=dev, generator=g).half()
    v = torch.randn(3, sk, kv, d, device=dev, generator=g).half()
    got = TO.flash_attention(q, k, v, causal=causal)
    want = TR.chunked_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    # a strided view (every other query head) takes the same path
    qs = q[:, :, ::2]
    ks, vs = (k, v) if kv == 1 else (k[:, :, ::2], v[:, :, ::2])
    torch.testing.assert_close(
        TO.flash_attention(qs, ks, vs, causal=causal).float(),
        TR.chunked_attention(qs, ks, vs, causal=causal).float(), atol=2e-2,
        rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,kv", [(64, 8, 8), (256, 8, 1), (128, 16, 2)],
                         ids=["D64-G1", "D256-G8", "D128-G8"])
def test_decode_kernels_other_shapes(d, h, kv):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    b, lc, bs = 3, 40, 16
    nb = -(-lc // bs) + 1                 # one garbage-padded column
    q = torch.randn(b, 1, h, d, device=dev, generator=g).half()
    kp = torch.randn(b * nb + 1, bs, kv, d, device=dev, generator=g).half()
    vp = torch.randn(b * nb + 1, bs, kv, d, device=dev, generator=g).half()
    bt = torch.arange(1, b * nb + 1, device=dev, dtype=torch.int32).reshape(
        b, nb).flip(1).contiguous()
    bt[:, -1] = 0
    pos = torch.tensor([0, 23, 70], dtype=torch.int32, device=dev)
    kc = kp[bt.long()].reshape(b, nb * bs, kv, d)[:, :lc].contiguous()
    vc = vp[bt.long()].reshape(b, nb * bs, kv, d)[:, :lc].contiguous()
    got_c = TO.decode_attention(q, kc, vc, pos, window=lc)
    got_p = TO.paged_decode_attention(q, kp, vp, bt, pos, logical_len=lc,
                                      window=lc)
    torch.testing.assert_close(got_c.float(),
                               TR.decode_attention(q, kc, vc, pos).float(),
                               atol=2e-2, rtol=2e-2)
    assert torch.equal(got_c, got_p)
    torch.testing.assert_close(
        TO.decode_attention(q, kc, vc, 5).float(),
        TR.decode_attention(q, kc, vc, 5).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_they_do_not_take():
    from repro_torch.kernels.flash_attention import kernel as TK
    dev = _cuda()
    q = torch.randn(1, 8, 4, 96, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        TK.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="CUDA"):
        TK.flash_attention_cuda(q.cpu(), q.cpu(), q.cpu())
    q = torch.randn(2, 1, 2 * TK.MAX_GROUP, 64, device=dev)
    kc = torch.randn(2, 32, 1, 64, device=dev)
    with pytest.raises(ValueError, match="query heads per KV head"):
        TK.decode_attention_cuda(q, kc, kc, 3)
    q8 = q[:, :, :8].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        TK.decode_attention_cuda(q[:, :, :8], kc, kc, 3)
    with pytest.raises(ValueError, match="dtype"):
        TK.decode_attention_cuda(q8, kc.half(), kc.half(), 3)
    kp = torch.randn(4, 8, 1, 64, device=dev)
    with pytest.raises(ValueError, match="block size"):
        TK.paged_decode_attention_cuda(
            q8, kp, kp, torch.zeros(2, 2, dtype=torch.int32, device=dev), 3,
            logical_len=16)


# -- the tensor-core prefill and the split decode, on the card --------------

@pytest.fixture
def cuda():
    return _cuda()


def _rand_qkv(dev, seed, b, sq, sk, h, kv, d, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, device=dev, generator=g).to(dtype)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [64, 200, 512])
def test_prefill_wgmma_jamba_heads(cuda, s):
    """Jamba-1.5-Large's attention layer: 64 query heads on 8 KV heads of
    128, one request."""
    q, k, v = _rand_qkv(cuda, 3, 1, s, s, 64, 8, 128, torch.bfloat16)
    dispatch.LAUNCHES.reset()
    got = TO.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.get("flash_attention") == 1
    torch.testing.assert_close(got.float(),
                               TR.chunked_attention(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,h,kv", [(64, 8, 2), (80, 8, 8), (128, 12, 2),
                                   (256, 8, 1)],
                         ids=["D64", "D80", "D128", "D256"])
@pytest.mark.parametrize("sq,sk,causal,window",
                         [(384, 1024, True, 0), (130, 130, True, 50),
                          (190, 257, True, 0), (100, 300, False, 0),
                          (65, 40, True, 0)])
def test_prefill_wgmma_head_dims_and_edges(cuda, dtype, d, h, kv, sq, sk,
                                           causal, window):
    """Every head dim and both 16-bit types on the tensor-core kernel:
    query offsets off the tile (Sq != Sk), a window, ragged key tiles past
    Sk, and rows that see no key (Sq > Sk) returning 0."""
    q, k, v = _rand_qkv(cuda, 4, 2, sq, sk, h, kv, d, dtype)
    got = TO.flash_attention(q, k, v, causal=causal, window=window)
    want = TR.chunked_attention(q, k, v, causal=causal, window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,sq,sk", [
    (torch.bfloat16, 8, 1500, 1500), (torch.bfloat16, 8, 448, 1500),
    (torch.bfloat16, 8, 37, 1500), (torch.float32, 2, 100, 100),
    (torch.float32, 2, 37, 100)],
    ids=["enc-1500", "cross-448x1500", "cross-37x1500", "fp32-100",
         "fp32-37x100"])
def test_prefill_whisper_shapes(cuda, dtype, b, sq, sk):
    """Whisper's attention, non-causal at 6/6 heads of 64: the encoder's
    1500 frames (ragged last key and query tiles: 1500 = 23 * 64 + 28) and
    the decoder's tokens against them (Sq < Sk, nothing shifted by the
    offset), the serve forward and the training forward with its lse
    against the plain versions; two calls bitwise equal."""
    from repro_torch.kernels.flash_attention import kernel as TK
    h = kv = 6 if dtype == torch.bfloat16 else 2
    q, k, v = _rand_qkv(cuda, 8, b, sq, sk, h, kv, 64, dtype)
    got = TK.flash_attention_cuda(q, k, v, causal=False)
    out, lse = TK.flash_attention_cuda(q, k, v, causal=False,
                                       return_lse=True)
    again = TK.flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    want, want_lse = TR.flash_attention_fwd(q, k, v, causal=False)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for o in (got, out):
        torch.testing.assert_close(o.float(), want.float(), atol=tol,
                                   rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_whisper_cross_cache(cuda, dtype):
    """The cross-attention decode: every one of 1500 encoder slots read at
    pos 1499 (the last 16-slot tile ragged: 1500 = 93 * 16 + 12), B8, 6/6
    heads of 64, as the plain version and the plain split; and the decoder's
    self-attention through pages, bitwise its contiguous cache."""
    _check_decode(cuda, dtype, 8, 6, 6, 64, 1500)
    from repro_torch.kernels.flash_attention import kernel as TK
    q, kp, vp, bt, kc, vc = _paged_case(cuda, 6, 8, 6, 6, 64, 1500, dtype)
    got = TK.decode_attention_cuda(q, kc, vc, 1499)
    torch.cuda.synchronize()
    _, n_split = TK.split_plan(1500, 8, 6)
    pos = torch.full((8,), 1499, dtype=torch.int32, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for want in (TR.decode_attention(q, kc, vc, pos),
                 TR.decode_attention_split(q, kc, vc, pos, n_split)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
def test_prefill_wgmma_refuses_strides_tma_cannot_take(cuda):
    from repro_torch.kernels.flash_attention import kernel as TK
    q = torch.randn(1, 8, 4, 68, device=cuda, dtype=torch.bfloat16)
    qs = q[..., :64]                      # head stride 136 bytes
    k = torch.randn(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        TK.flash_attention_cuda(qs, k, k)
    flat = torch.randn(1 + 8 * 4 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        TK.flash_attention_cuda(flat[1:].view(1, 8, 4, 64), k, k)
    # fp32 takes the CUDA-core kernel, which reads any stride
    torch.testing.assert_close(
        TK.flash_attention_cuda(qs.float(), k.float(), k.float()),
        TR.chunked_attention(qs.float(), k.float(), k.float()), atol=1e-4,
        rtol=1e-4)


def _paged_case(dev, seed, b, h, kv, d, lc, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = -(-lc // 16) + 1                 # one garbage-padded column
    n_blocks = b * nb + 1
    q = torch.randn(b, 1, h, d, device=dev, generator=g).to(dtype)
    kp = torch.randn(n_blocks, 16, kv, d, device=dev, generator=g).to(dtype)
    vp = torch.randn(n_blocks, 16, kv, d, device=dev, generator=g).to(dtype)
    bt = (torch.randperm(n_blocks - 1, generator=torch.Generator()
                         .manual_seed(seed)) + 1)[:b * nb].reshape(b, nb)
    bt = bt.to(torch.int32).to(dev)
    bt[:, -1] = 0
    kc = kp[bt.long()].reshape(b, nb * 16, kv, d)[:, :lc].contiguous()
    vc = vp[bt.long()].reshape(b, nb * 16, kv, d)[:, :lc].contiguous()
    return q, kp, vp, bt, kc, vc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,lc", [(64, 8, 40), (8, 8, 300), (8, 2, 1056),
                                     (2, 1, 2000)],
                         ids=["1-split", "G8-5-splits", "17-splits",
                              "125-splits"])
def test_decode_split_kernels(cuda, dtype, b, kv, lc):
    """G = 8 (Jamba) and G = 6 caches cut into 1 to 125 splits: decode and
    paged decode against the plain version and the plain split, paged ==
    contiguous bitwise, two identical calls bitwise equal.  pos lies before
    the first split boundary, on boundaries, and at or past lc."""
    h = kv * (8 if kv == 8 or kv == 1 else 6)
    _check_decode(cuda, dtype, b, h, kv, 128, lc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,d,lc", [(8, 32, 2, 128, 1056),
                                         (8, 96, 8, 128, 300),
                                         (3, 24, 2, 128, 2000),
                                         (8, 32, 32, 80, 1056),
                                         (2, 32, 2, 80, 500)],
                         ids=["G16", "G12", "G12-125-splits", "D80",
                              "G16-D80"])
def test_decode_split_kernels_wide_groups_and_d80(cuda, dtype, b, h, kv, d,
                                                  lc):
    """16 query heads a KV head (chatglm3-6b), 12 (mistral-large-123b; not
    a power of two) and head dim 80 (stablelm-3b), as the G <= 8 cases
    are held."""
    _check_decode(cuda, dtype, b, h, kv, d, lc)


def _check_decode(cuda, dtype, b, h, kv, d, lc):
    from repro_torch.kernels.flash_attention import kernel as TK
    q, kp, vp, bt, kc, vc = _paged_case(cuda, 5, b, h, kv, d, lc, dtype)
    per, n_split = TK.split_plan(lc, b, kv)
    choices = [0, 3, per * 16 - 1, per * 16, lc // 2, lc - 1, lc, 3 * lc]
    pos = torch.tensor([choices[(3 * i + 2) % len(choices)]
                        for i in range(b)],
                       dtype=torch.int32, device=cuda)
    dispatch.LAUNCHES.reset()
    got_c = TO.decode_attention(q, kc, vc, pos)
    got_p = TO.paged_decode_attention(q, kp, vp, bt, pos, logical_len=lc)
    again = TO.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES.snapshot() == {"decode_attention": 2,
                                            "paged_decode_attention": 1}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for want in (TR.decode_attention(q, kc, vc, pos),
                 TR.decode_attention_split(q, kc, vc, pos, n_split)):
        torch.testing.assert_close(got_c.float(), want.float(), atol=tol,
                                   rtol=tol)
    assert torch.equal(got_c, got_p)
    assert torch.equal(got_c, again)


@pytest.mark.gpu
def test_decode_split_workspace_follows_the_stream(cuda):
    """Decodes on two streams use two workspaces, and each stream's result
    equals the default stream's bitwise."""
    q, kp, vp, bt, kc, vc = _paged_case(cuda, 6, 4, 12, 2, 128, 500,
                                        torch.bfloat16)
    pos = torch.tensor([10, 200, 499, 900], dtype=torch.int32, device=cuda)
    want = TO.decode_attention(q, kc, vc, pos)
    outs = []
    for _ in range(2):
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append(TO.decode_attention(q, kc, vc, pos))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
