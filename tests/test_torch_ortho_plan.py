"""Kernel #5's launch plan and a plain model of its schedule, on the CPU (no
JAX): ``kernels/ortho.py::ortho_plan`` fits the card at every basis size,
its blocks' tiles cover the columns once, the bulk copies' aligned
supersets land each row segment where the kernel reads it for any
alignment of Q and w (odd n included), and a numpy model of the kernel's
partition and fixed-order sums (``csrc/ortho_fused.cu``: w1 a column at a
time over the rows in order, u2 a lane at a time over the columns in
order, a fixed shuffle tree over the lanes, the blocks' partials in block
order) equals the plain twin ``fused_update_matvec_torch`` within 1e-13
(f64) and 1e-5 (f32) of max|ref|, with the same bits on two runs."""

import numpy as np
import pytest
import torch

from structurepreservingiterativesolvers_torch.kernels import ortho

F64, F32 = torch.float64, torch.float32
# the paths' widths: swe M=512, heat M=1024 and heat P2 M=512 (odd),
# lkdvRK (3, 2) M=400, and small ragged ones
WIDTHS = (1, 31, 1001, 9600, 786432, 1050625)


def _size(dtype):
    return 8 if dtype == F64 else 4


def test_plan_fits_the_card_at_every_basis_size():
    """Every m in 1..128, both dtypes: the stages fit the 227 KB a block may
    use, at least 3 of them (S (m + 1) BN size within it), BN a power of
    two of at least a warp's 32 columns whose rows are whole 16 bytes, the
    grid at most one block an SM and one a BN-wide piece of n, and a
    block's 288 threads within the card's 1,024."""
    assert ortho.THREADS == 288 <= 1024
    for dtype in (F64, F32):
        size = _size(dtype)
        for n in (786432, 9600, 1001):
            for m in range(1, ortho.MAX_ROWS + 1):
                p = ortho.ortho_plan(m, n, dtype)
                assert p.smem == ortho.smem_bytes(m, p.bn, p.stages, size)
                assert p.smem <= ortho.SMEM_MAX == 232448
                assert p.stages * (m + 1) * p.bn * size <= ortho.SMEM_MAX
                assert ortho.MIN_STAGES <= p.stages <= ortho.MAX_STAGES
                assert p.bn >= 32 and p.bn & (p.bn - 1) == 0
                assert p.bn * size % 16 == 0
                assert p.ntiles == -(-n // p.bn)
                assert 1 <= p.grid == min(ortho.SMS, p.ntiles) <= 132


def test_plan_at_the_paths_shapes():
    """The path shapes' launches: one block an SM with 3 stages at swe
    M=512 (m = 21, 61) and heat P2 M=512 (m = 31); lkdvRK's n = 9,600
    narrowed to 128 columns, a tile on each of 75 blocks (more than half
    the SMs)."""
    assert ortho.ortho_plan(21, 786432, F64)[:3] == (256, 3, 132)
    assert ortho.ortho_plan(61, 786432, F64)[:3] == (128, 3, 132)
    assert ortho.ortho_plan(31, 1050625, F64)[:3] == (256, 3, 132)
    assert ortho.ortho_plan(21, 786432, F32)[:3] == (512, 3, 132)
    p = ortho.ortho_plan(8, 9600, F64)
    assert (p.bn, p.grid, p.ntiles) == (128, 75, 75)
    assert 2 * p.grid >= ortho.SMS


def test_tiles_cover_the_columns_once():
    """For each width, dtype and a few m, the blocks' tiles (b, b + G, ...):
    they cut [0, n) once, each block's non-empty and in increasing order,
    every tile starting on a whole 16 bytes of elements and at most BN
    wide."""
    for dtype in (F64, F32):
        size = _size(dtype)
        for n in WIDTHS:
            for m in (1, 21, 61, 128):
                p = ortho.ortho_plan(m, n, dtype)
                tiles = []
                for b in range(p.grid):
                    mine = ortho.block_tiles(p, n, b)
                    assert mine, (n, m, b)
                    assert [c0 for c0, _ in mine] == sorted(
                        c0 for c0, _ in mine)
                    tiles += mine
                nxt = 0
                for c0, cols in sorted(tiles):
                    assert c0 == nxt and 1 <= cols <= p.bn
                    assert c0 * size % 16 == 0
                    nxt = c0 + cols
                assert nxt == n


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_supersets_land_each_segment_where_it_is_read(dtype):
    """Odd n (1,050,625, 1,001), Q and w at every element alignment: each
    row segment's bulk copy starts and ends on 16 bytes, fits the padded
    shared row (BN size + 16), and puts element c0 + cc of the row at the
    kernel's offset + cc, that offset being (addr(Q) + r ld size) mod 16
    whatever the tile; a tile goes by bulk copies exactly where the
    supersets stay inside Q and w."""
    size = _size(dtype)
    for n, m in ((1050625, 5), (1001, 21)):
        p = ortho.ortho_plan(m, n, dtype)
        ld = n
        for q_addr in range(4096, 4096 + 16, size):
            for w_addr in (1 << 20, (1 << 20) + size):
                q_end = q_addr + ((m - 1) * ld + n) * size
                qa16, ldm = q_addr % 16, ld * size % 16
                for b in (0, 1, p.grid // 2, p.grid - 1):
                    for c0, cols in ortho.block_tiles(p, n, b):
                        bulk = ortho.tile_bulk(c0, cols, m, n, ld, q_addr,
                                               w_addr, size)
                        inside = True
                        for r in range(m + 1):
                            base = (q_addr + r * ld * size if r < m
                                    else w_addr)
                            addr = base + c0 * size
                            lo, nbytes, off = ortho.row_segment(addr, cols,
                                                                size)
                            assert lo % 16 == 0 and nbytes % 16 == 0
                            assert nbytes <= p.bn * size + 16
                            # element c0 + cc sits at lo + (off + cc) size
                            assert lo + off * size == addr
                            assert addr + cols * size <= lo + nbytes
                            if r < m:
                                assert off == ((qa16 + (r % 4) * ldm) % 16
                                               ) // size
                                inside &= q_addr <= lo and lo + nbytes <= q_end
                            else:
                                assert off == (w_addr % 16) // size
                                inside &= (w_addr <= lo and lo + nbytes
                                           <= w_addr + n * size)
                        assert bulk == inside, (n, m, b, c0, q_addr, w_addr)
        # an odd m n: the last tile's supersets pass the ends, plain loads
        last = max(t for b in range(p.grid)
                   for t in ortho.block_tiles(p, n, b))
        assert not ortho.tile_bulk(*last, m, n, ld, 4096, 1 << 20, size)


def _tree(v):
    """The kernel's shuffle tree over 32 lanes (``warp_sum``): lane 0's sum."""
    v = v.copy()
    for off in (16, 8, 4, 2, 1):
        v[..., :off] = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def kernel_model(Q, w, h, plan):
    """The kernel's arithmetic in numpy, in its order (separate multiplies
    and adds where the kernel fuses them): per block, per tile, w1 for
    each column over the rows in order; each (row, lane) sum over the
    lane's columns in order, across the block's tiles; the lanes' tree; the
    blocks' partials, lane l over blocks l, l + 32, ..., then the tree."""
    m, n = Q.shape
    w1 = np.empty(n, dtype=Q.dtype)
    partial = np.zeros((plan.grid, m), dtype=Q.dtype)
    for b in range(plan.grid):
        acc = np.zeros((m, 32), dtype=Q.dtype)
        for c0, cols in ortho.block_tiles(plan, n, b):
            s = np.zeros(cols, dtype=Q.dtype)
            for r in range(m):
                s = s + h[r] * Q[r, c0:c0 + cols]
            x = w[c0:c0 + cols] - s
            w1[c0:c0 + cols] = x
            k = -(-cols // 32)
            P = np.zeros((m, 32 * k), dtype=Q.dtype)
            P[:, :cols] = Q[:, c0:c0 + cols] * x
            P = P.reshape(m, k, 32)
            for i in range(k):
                acc = acc + P[:, i, :]
        partial[b] = _tree(acc)
    chunks = -(-ortho.SMS // 32)
    parts = np.zeros((m, 32 * chunks), dtype=Q.dtype)
    parts[:, :plan.grid] = partial.T
    parts = parts.reshape(m, chunks, 32)
    v = np.zeros((m, 32), dtype=Q.dtype)
    for q in range(chunks):
        v = v + parts[:, q, :]
    return w1, _tree(v)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_model_of_the_schedule_matches_the_plain_twin(dtype):
    """The model against ``fused_update_matvec_torch`` on seeded inputs at
    lkdvRK's n = 9,600 (m = 8, 21), an odd n = 1,001 (m = 5, 128) and swe
    M=512's n (m = 3): max|Δ| / max|ref| within 1e-13 (f64) and 1e-5
    (f32) on w1 and u2, with random h so that u2 does not cancel; two runs
    of the model give the same bits."""
    rtol = 1e-13 if dtype == F64 else 1e-5
    npd = np.float64 if dtype == F64 else np.float32
    rng = np.random.default_rng(16)
    for m, n in ((8, 9600), (21, 9600), (5, 1001), (128, 1001), (3, 786432)):
        Q = rng.standard_normal((m, n)).astype(npd)
        w = rng.standard_normal(n).astype(npd)
        h = rng.standard_normal(m).astype(npd)
        plan = ortho.ortho_plan(m, n, dtype)
        w1, u2 = kernel_model(Q, w, h, plan)
        w1b, u2b = kernel_model(Q, w, h, plan)
        assert np.array_equal(w1, w1b) and np.array_equal(u2, u2b)
        r1, r2 = ortho.fused_update_matvec_torch(
            torch.from_numpy(Q), torch.from_numpy(w), torch.from_numpy(h))
        r1, r2 = r1.numpy(), r2.numpy()
        assert np.abs(w1 - r1).max() <= rtol * np.abs(r1).max(), (m, n)
        assert np.abs(u2 - r2).max() <= rtol * np.abs(r2).max(), (m, n)
