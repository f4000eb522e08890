"""The selective-scan kernels' decompositions, on the CPU.

``kernel.scan_plan`` cuts a (Ba, S, Di, N) scan into blocks of CHANNELS
channels, N / 4 lanes a channel and time tiles of TILE steps, and
``kernel.bwd_plan`` the backward into blocks of BWD_CHANNELS channels, two
a thread, and tiles of BWD_TILE steps (one saved state each) walked as
sub-tiles of BWD_SUB; every (b, t, d, n) must fall to exactly one thread
and step.  ``vector_loads``
decides whether the tiles are staged with 16-byte copies.  The plain
``ref.selective_scan_lanes`` computes the scan in the kernel's order (exp2
of dt times A * log2 e, four states a lane, lanes summed pairwise) and is
held against the reference package's ``selective_scan`` (nonzero h0) and
the Pallas kernel in interpret mode (zero h0: the TPU wrapper sends a
nonzero one to its ref) at fp32 rtol = atol = 1e-4, with a random A.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import ref as JR
from repro.kernels.selective_scan.kernel import selective_scan_tpu
from repro_torch.kernels.selective_scan import kernel as TK
from repro_torch.kernels.selective_scan import ref as TR

TOL = dict(rtol=1e-4, atol=1e-4)
# one thread a (batch, channel), 128 a block: the design this one replaced
OLD_CHANNELS = 128


def _inputs(ba, s, di, n, seed=0):
    """u, dt (softplus of a normal), A = -exp(A_log) with A_log ~ N(0, 0.5)
    per (d, n), B, C, D and a nonzero h0, as numpy arrays."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(ba, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(ba, s, di)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(di, n)) * 0.5).astype(np.float32)
    b = rng.normal(size=(ba, s, n)).astype(np.float32)
    c = rng.normal(size=(ba, s, n)).astype(np.float32)
    d = rng.normal(size=(di,)).astype(np.float32)
    h0 = rng.normal(size=(ba, di, n)).astype(np.float32)
    return [u, dt, a, b, c, d], h0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _owners(ba, s, di, n):
    """How many times the plan's threads and steps reach each (b, t, d, n)."""
    p = TK.scan_plan(ba, s, di, n)
    seen = np.zeros((ba, s, di, n), np.int64)
    tid = np.arange(p.threads)
    ch, q = tid % TK.CHANNELS, tid // TK.CHANNELS
    for b in range(p.grid[1]):
        for x in range(p.grid[0]):
            d = x * TK.CHANNELS + ch
            for k in range(p.tiles):
                for j in range(TK.TILE):
                    t = k * TK.TILE + j
                    if t >= s:
                        break
                    for i in range(TK.STATES_PER_LANE):
                        keep = d < di
                        np.add.at(seen, (b, t, d[keep],
                                         q[keep] * TK.STATES_PER_LANE + i), 1)
    return p, seen


def _bwd_owners(ba, s, di, n):
    """How many times the backward plan's threads, tiles and sub-tiles reach
    each (b, t, d, n), and the saved states its tiles start from."""
    p = TK.bwd_plan(ba, s, di, n)
    seen = np.zeros((ba, s, di, n), np.int64)
    tid = np.arange(p.threads)
    lane, q = tid % 32, tid // 32
    for b in range(p.grid[1]):
        for x in range(p.grid[0]):
            for k in range(TK.BWD_PAIR):
                d = x * TK.BWD_CHANNELS + TK.BWD_PAIR * lane + k
                keep = d < di
                for tile in range(p.tiles):
                    for sub in range(TK.BWD_TILE // TK.BWD_SUB):
                        for j in range(TK.BWD_SUB):
                            t = tile * TK.BWD_TILE + sub * TK.BWD_SUB + j
                            if t >= s:
                                continue
                            for i in range(TK.STATES_PER_LANE):
                                np.add.at(seen, (b, t, d[keep],
                                                 q[keep] * 4 + i), 1)
    return p, seen


@pytest.mark.parametrize("ba,s,di,n", [(1, 1, 64, 16), (2, 33, 48, 4),
                                       (1, 12, 100, 8), (2, 70, 130, 16),
                                       (3, 8, 7, 4)])
def test_bwd_plan_covers_every_element_once(ba, s, di, n):
    """The backward's grid, lanes, channel pairs, tiles and sub-tiles reach
    every (b, t, d, n) once, and the saved states hold one state a tile:
    ``states_shape`` follows the save interval ``BWD_TILE``."""
    p, seen = _bwd_owners(ba, s, di, n)
    assert (seen == 1).all()
    assert p.threads == 32 * p.lanes and p.lanes * 4 == n
    assert TK.BWD_CHANNELS == 32 * TK.BWD_PAIR
    assert p.grid == (-(-di // TK.BWD_CHANNELS), ba)
    assert p.tiles * TK.BWD_TILE >= s > (p.tiles - 1) * TK.BWD_TILE
    assert TK.BWD_TILE == 2 * TK.BWD_SUB and TK.TILE % TK.BWD_TILE == 0
    assert TK.states_shape(ba, s, di, n) == (ba, p.tiles, n // 4, di, 4)
    assert TK.bwd_plan(ba, s, di, n) == p                 # pure


@pytest.mark.parametrize("ba,s,di,n", [(1, 1, 32, 16), (2, 33, 48, 4),
                                       (1, 64, 100, 8), (2, 70, 200, 16),
                                       (3, 31, 8, 4), (1, 96, 64, 16)])
def test_scan_plan_covers_every_element_once(ba, s, di, n):
    p, seen = _owners(ba, s, di, n)
    assert (seen == 1).all()
    assert p.lanes * TK.STATES_PER_LANE == n
    assert p.threads == TK.CHANNELS * p.lanes and p.threads % 32 == 0
    assert p.tiles * TK.TILE >= s > (p.tiles - 1) * TK.TILE
    assert TK.scan_plan(ba, s, di, n) == p                # pure


@pytest.mark.parametrize("ba,s", [(1, 512), (1, 64), (2, 512)])
def test_scan_plan_fills_the_card_at_the_serve_shapes(ba, s):
    """Jamba's serve prefills scan one prompt at a time (Ba 1, S 64-512) and
    the timing shape is Ba 2: at least 4x the warps of one thread a channel,
    and at least 8 warps for each of the H100's 132 SMs."""
    di, n = 16384, 16
    p = TK.scan_plan(ba, s, di, n)
    old_warps = ba * -(-di // OLD_CHANNELS) * OLD_CHANNELS // 32
    assert p.warps >= 4 * old_warps
    assert p.warps >= 8 * 132
    assert p.warps == ba * di * (n // TK.STATES_PER_LANE) // 32
    assert p.tiles == -(-s // TK.TILE)


def test_vector_loads_needs_aligned_rows_and_whole_chunks():
    ba, s, di, n = 2, 70, 200, 16
    u = torch.zeros(ba, s, di, dtype=torch.bfloat16)
    dt = torch.zeros(ba, s, di)
    b, c = torch.zeros(ba, s, n), torch.zeros(ba, s, n)
    assert TK.vector_loads(u, dt, b, c)
    # B and C as the Mamba layer hands them over: column views of x_proj's
    # output (dt_rank 512, then N of B and N of C)
    xdb = torch.zeros(ba, s, 512 + 2 * n)
    assert TK.vector_loads(u, dt, xdb[..., 512:512 + n], xdb[..., 512 + n:])
    # a column view off a 16-byte boundary, or a row stride that is not a
    # whole number of 16-byte units, is staged by plain loads
    odd = torch.zeros(ba, s, 3 + 2 * n)
    assert not TK.vector_loads(u, dt, odd[..., 3:3 + n], odd[..., 3 + n:])
    assert not TK.vector_loads(u, dt, odd[..., :n], c)
    # Di not a multiple of 8: a 16-byte chunk of u would straddle Di
    assert not TK.vector_loads(u[..., :196], dt[..., :196], b, c)
    # a u view with a padded row stays aligned
    wide = torch.zeros(ba, s, 256, dtype=torch.bfloat16)
    assert TK.vector_loads(wide[..., :di], dt, b, c)
    assert not TK.vector_loads(wide[..., 4:4 + di], dt, b, c)
    # a dimension of size 1 has no stride to speak of
    assert TK.vector_loads(u[:1, :1], dt[:1, :1], b[:1, :1], c[:1, :1])


# ragged S (off the tile), S = 1, S shorter than one tile, N 4, 8 and 16,
# Di off the block of channels
LANE_SHAPES = [(2, 70, 48, 16), (1, 1, 32, 16), (2, 12, 40, 8),
               (1, 100, 24, 4), (2, 64, 64, 8), (1, 33, 16, 16)]


@pytest.mark.parametrize("ba,s,di,n", LANE_SHAPES)
def test_lane_order_matches_reference_and_pallas(ba, s, di, n):
    arrs, h0 = _inputs(ba, s, di, n, seed=s + di + n)
    tin = [torch.from_numpy(x.copy()) for x in arrs]
    jin = [jnp.asarray(x) for x in arrs]
    # nonzero h0: the reference package's jnp scan
    y, h = TR.selective_scan_lanes(*tin, h0=torch.from_numpy(h0))
    assert y.shape == (ba, s, di) and h.shape == (ba, di, n)
    ry, rh = JR.selective_scan(*jin, chunk=32, h0=jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(ry), **TOL)
    np.testing.assert_allclose(_np(h), _np(rh), **TOL)
    # zero h0: the Pallas kernel in interpret mode
    y0, h0_ = TR.selective_scan_lanes(*tin)
    py, ph = selective_scan_tpu(*jin, chunk=32, bd=8, interpret=True)
    np.testing.assert_allclose(_np(y0), _np(py), **TOL)
    np.testing.assert_allclose(_np(h0_), _np(ph), **TOL)


def test_lane_order_matches_the_step_loop_in_bf16():
    """bf16 u: the kernel's order and the step loop read the same rounded
    u; their fp32 states agree at the fp32 tier and y within a bf16 ulp."""
    arrs, h0 = _inputs(2, 45, 32, 16, seed=9)
    u, *rest = [torch.from_numpy(x.copy()) for x in arrs]
    u = u.to(torch.bfloat16)
    y, h = TR.selective_scan_lanes(u, *rest, h0=torch.from_numpy(h0))
    wy, wh = TR.selective_scan(u, *rest, h0=torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(h, wh, **TOL)
    torch.testing.assert_close(y.float(), wy.float(), rtol=2.0 ** -7,
                               atol=1e-4)
