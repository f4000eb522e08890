"""The decode kernel's split of the cache, on the CPU.

``kernel.split_plan`` cuts a cache into runs of whole 16-slot tiles; the
plain ``ref.decode_attention_split`` computes one partial per run and merges
them in run order, as the kernel does.  It is held against the reference
package's ``decode_attention`` at the fp32 tier of tests/test_kernels.py
(2e-5), for split counts that leave runs past the cache and runs wholly
past ``pos``, up to 16 query heads a KV head and at head dim 80.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as JR
from repro_torch.kernels.flash_attention import kernel as TK
from repro_torch.kernels.flash_attention import ref as TR

TOL = 2e-5


@pytest.mark.parametrize("lc,b,kv", [(1056, 8, 2), (1056, 1, 1), (16, 64, 8),
                                     (1, 1, 1), (72, 4, 2), (40, 3, 8),
                                     (4096, 1, 2), (1000, 4, 2),
                                     (1023, 8, 8)])
def test_split_plan_covers_the_cache_in_whole_tiles(lc, b, kv):
    per, n_split = TK.split_plan(lc, b, kv)
    ntiles = -(-lc // TK.PAGE_TILE)
    assert per >= 1 and n_split >= 1
    # every split starts on a tile and holds at least one; together they
    # cover [0, lc) exactly once
    runs = [(z * per * TK.PAGE_TILE, min((z + 1) * per * TK.PAGE_TILE, lc))
            for z in range(n_split)]
    assert all(lo < hi for lo, hi in runs)
    covered = np.zeros(lc, np.int64)
    for lo, hi in runs:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert (n_split - 1) * per < ntiles <= n_split * per
    # the longest runs that still give the blocks wanted: one tile less a
    # run would make more than DECODE_BLOCKS blocks
    assert per == 1 or b * kv * -(-ntiles // (per - 1)) > TK.DECODE_BLOCKS
    assert TK.split_plan(lc, b, kv) == (per, n_split)     # pure


def test_contiguous_and_paged_wrappers_hand_over_the_same_plan(monkeypatch):
    """Both wrappers reach the launch with the same logical length, batch
    and KV heads, so ``split_plan`` cuts both caches alike."""
    seen = []
    monkeypatch.setattr(TK, "_check_common", lambda *a, **k: None)
    monkeypatch.setattr(TK, "_launch_decode", lambda name, q, k, v, pos_b, bt,
                        lc, *rest: seen.append(
                            (name, TK.split_plan(lc, q.shape[0], k.shape[2]))))
    b, h, kv, d, lc = 3, 12, 2, 64, 200
    nb = -(-lc // 16) + 1
    q = torch.zeros(b, 1, h, d)
    pages = torch.zeros(b * nb + 1, 16, kv, d)
    TK.decode_attention_cuda(q, torch.zeros(b, lc, kv, d),
                             torch.zeros(b, lc, kv, d), 5)
    TK.paged_decode_attention_cuda(
        q, pages, pages, torch.zeros(b, nb, dtype=torch.int32), 5,
        logical_len=lc)
    assert [n for n, _ in seen] == ["decode_attention",
                                    "paged_decode_attention"]
    assert seen[0][1] == seen[1][1] == TK.split_plan(lc, b, kv)


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 9, 40])
@pytest.mark.parametrize("h,kv,d", [(12, 2, 64), (16, 2, 32), (24, 2, 80),
                                   (32, 2, 80)],
                         ids=["G6", "G8", "G12-D80", "G16-D80"])
def test_split_decode_plain_matches_reference(n_split, h, kv, d):
    rng = np.random.default_rng(7)
    b, lc = 5, 130                        # 9 tiles, the last one ragged
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, 1, h, d), (b, lc, kv, d), (b, lc, kv, d)))
    # before the first split boundary, on a tile edge, mid-cache, the last
    # slot, and past the cache (every slot valid)
    pos = np.asarray([3, 16, 70, 129, 400], np.int32)
    want = JR.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos))
    got = TR.decode_attention_split(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), torch.as_tensor(pos),
                                    n_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_split_decode_plain_gives_zero_for_no_valid_slot():
    """pos < 0 leaves every split empty: the merge returns 0, not NaN."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((2, 1, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32)))
    got = TR.decode_attention_split(q, k, v, torch.tensor([-1, 20]), 3)
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got[0]) == 0
    torch.testing.assert_close(got[1], TR.decode_attention(
        q, k, v, torch.tensor([-1, 20]))[1], rtol=TOL, atol=TOL)


def test_decode_takes_up_to_sixteen_query_heads_a_kv_head():
    """The kernel's MAX_GROUP (read from the source) sizes the workspace's
    (m, l) floats: 16 query heads a KV head pass the wrapper's checks (a
    CPU tensor then fails only the device check), 32 are refused; head dim
    80 is taken by every kernel."""
    assert TK.MAX_GROUP == 16
    assert 80 in TK.HEAD_DIMS and 80 in TK.BWD_HEAD_DIMS
    kc = torch.zeros(1, 32, 1, 64)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        TK.decode_attention_cuda(torch.zeros(1, 1, 16, 64), kc, kc, 3)
    with pytest.raises(ValueError, match="query heads per KV head"):
        TK.decode_attention_cuda(torch.zeros(1, 1, 32, 64), kc, kc, 3)
