"""The batched DIA kernel's designs (``csrc/dia_spmm.cu``) on the CPU, where
the kernel cannot run:

* ``kernels/dia_spmv.py::spmm_plan`` picks its design, tile and vector
  split at the port's path shapes from their numbers alone, and
  ``spmm_strip`` cuts swe's rows into its three fields;
* a plain emulation of the designs' schedule, a model of the kernel for
  these tests and used nowhere else: blocks taken in strips, each warp's
  chunk word walked in ascending d, tiles of vectors, block columns of
  vectors over the grid, x read unchecked where a warp's columns lie in
  [0, n) and through the wrap or zero fill elsewhere, on rows at an odd
  stride from an odd first element, for odd offsets, odd n and a ragged
  last block, in f64 and f32 (the kernel's rows a thread, 2 and 4).  At
  B = 1, 3, 8, 9, 41 each design gives the plain twin ``dia_spmm_torch``'s
  bits on finite x, and is held to the JAX package's
  ``ops/sparse.py::dia_spmm`` at swe M=16 and lkdv degree 3 M=100 (f64,
  1e-14 of max|Y|: the same sums in the same order, where a skipped
  diagonal's exact zero term changes at most the sign of a zero).

The kernel itself is held to its twin and to kernel #1 on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
from structurepreservingiterativesolvers_torch.models import heat, lkdv, swe
from structurepreservingiterativesolvers_torch.ops.sparse import DIA

BATCHES = (1, 3, 8, 9, 41)


def _swe_offsets(M):
    """swe's 21 offsets at any M (models/swe.py's stencil, as assembled at
    M=16 and M=64)."""
    far = (M * M + 2 * M - 1, M * M + M, M * M + M - 1, M * M + 1, M * M,
           M * M - 1, M * M - M + 1, M * M - M, M * M - 2 * M + 1)
    return tuple(sorted({0, M, -M, *far, *(-f for f in far)}))


@functools.lru_cache(maxsize=None)
def _operators():
    """label -> DIA: swe M=16's A (wrapped, three strips), its zero-filled
    twin, lkdv degree 3 M=100's A and mass matrix, and a ragged odd-n
    operator with odd offsets and a dead segment."""
    rng = np.random.default_rng(5)
    out = {"swe_M16_A": swe.linforms(M=16, device="cpu").A}
    A = out["swe_M16_A"]
    out["swe_M16_A_zero_filled"] = DIA(A.data, A.offsets, A.shape, False)
    s = lkdv.linforms(M=100, degree=3, device="cpu")
    out["lkdv_M100_deg3_A"], out["lkdv_M100_deg3_Mmat"] = s.A, s.Mmat
    data = torch.as_tensor(rng.standard_normal((6, 1001)))
    data[:, 300:500] = 0.0
    out["ragged"] = DIA(data, (-287, -255, -3, 0, 5, 600), (1001, 1001), False)
    return out


def _block_span(bid, R, strip, n):
    strips = -(-n // strip)
    f, p = bid % strips, bid // strips
    r0 = f * strip + p * R
    return r0, min(r0 + R, (f + 1) * strip, n)


def _word(A, w0, dtype):
    """The plan's word of the warp starting at row w0 (the dense design's
    every bit where the plan does not pay)."""
    plan = A.live()
    if not plan.pays:
        return (1 << len(A.offsets)) - 1
    return int(plan.words[w0 // plan.chunk]) & ((1 << len(A.offsets)) - 1)


def _bits(word):
    return [d for d in range(64) if word >> d & 1]


def _x_cols(X, cols, wrap):
    """x at the columns ``cols`` of every vector of X: wrapped mod n or 0
    outside [0, n) (x_at)."""
    n = X.shape[0]
    if wrap:
        return X[cols % n]
    ok = (cols >= 0) & (cols < n)
    return torch.where(ok[:, None], X[cols.clamp(0, n - 1)], X.new_zeros(()))


def _schedule(A, X, plan, rpt=2):
    """The tile and spread designs' schedule: each block column takes
    ``plan.split`` vectors, each block its rows in strips, each warp its
    32 rpt rows and its chunk's word; a tile of vectors sums its diagonals
    in ascending d, x read unchecked where the warp's columns lie in
    [0, n).  Returns Y; every entry is written once."""
    n, B = X.shape
    R, WR = kd.SPMM_THREADS * rpt, 32 * rpt
    blocks = -(-n // plan.strip) * -(-plan.strip // R)
    Y = torch.zeros((n, B), dtype=X.dtype)
    written = torch.zeros((n, B), dtype=torch.int64)
    for g0 in range(0, B, plan.split):
        g1 = min(B, g0 + plan.split)
        for bid in range(blocks):
            r0, end = _block_span(bid, R, plan.strip, n)
            for w0 in range(r0, end, WR):
                rows = torch.arange(w0, min(w0 + WR, end))
                full = w0 + WR <= end
                word = _word(A, w0, X.dtype)
                for b0 in range(g0, g1, plan.tile):
                    vecs = slice(b0, min(b0 + plan.tile, g1))
                    acc = torch.zeros((len(rows), vecs.stop - b0), dtype=X.dtype)
                    for d in _bits(word):
                        off = A.offsets[d]
                        if full and w0 + off >= 0 and w0 + off + WR <= n:
                            xv = X[rows + off, vecs]
                        else:
                            xv = _x_cols(X[:, vecs], rows + off, A.wrap)
                        acc = acc + A.data[d, rows][:, None] * xv
                    Y[rows, vecs] = acc
                    written[rows, vecs] += 1
    assert (written == 1).all()
    return Y


def _block(n, B, ldx, x0, dtype=torch.float64, seed=0):
    """A storage holding B rows of n at stride ldx from element x0, and
    the (n, B) view of them."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(x0 + B * ldx + 3, generator=g, dtype=dtype)
    return flat, flat[x0:x0 + B * ldx].reshape(B, ldx)[:, :n].T


@functools.lru_cache(maxsize=None)
def _product(label, design, B, dtype=torch.float64, rpt=2):
    """The emulated product of ``design`` on operator ``label`` with B
    vectors held at an odd row stride from an odd first element, and the
    block X; kept, so that the JAX comparison reuses it."""
    A = _operators()[label]
    A = A if dtype == torch.float64 else A.astype(dtype)
    n = A.shape[0]
    ldx = n + 1 if n % 2 == 0 else n
    flat, X = _block(n, B, ldx, 1, dtype, seed=B)
    plan = kd.spmm_design(design, n, B, dtype,
                          kd.spmm_strip(n, A.offsets, dtype))
    return _schedule(A, X, plan, rpt), X


def test_spmm_plan_picks_at_path_shapes():
    """From the shapes alone: swe M=512 (three strips of M^2 rows) runs
    spread for one vector and tile for more (tile 4 up to 4 vectors, else
    8), heat M=1024's A and energy matrix tile (one strip, its offsets are
    near), lkdvRK (3, 2) M=400 and lkdv's mass matrices spread, one vector
    a block column."""
    n = 3 * 512 ** 2
    strip = kd.spmm_strip(n, _swe_offsets(512), torch.float64)
    assert strip == 512 ** 2
    picks = {B: kd.spmm_plan(n, B, torch.float64, strip) for B in (1, 2, 3, 8, 41)}
    assert {B: (p.design, p.tile, p.split) for B, p in picks.items()} == {
        1: ("spread", 1, 1), 2: ("tile", 4, 2), 3: ("tile", 4, 3),
        8: ("tile", 8, 8), 41: ("tile", 8, 41)}
    assert all(p.strip == strip and p.depth == 1 for B, p in picks.items() if B > 1)
    heat_n = 1025 ** 2
    heat_offsets = (-1026, -1025, -1, 0, 1, 1025, 1026)
    assert kd.spmm_strip(heat_n, heat_offsets, torch.float64) == heat_n
    for B in (8, 15):  # the batched width, and the heat row's catch-up
        assert kd.spmm_plan(heat_n, B, torch.float64, heat_n)[:3] == ("tile", 8, B)
    for n_small, B in ((9600, 8), (1600, 16), (400, 32)):
        p = kd.spmm_plan(n_small, B, torch.float64, n_small)
        assert (p.design, p.tile, p.split, p.depth) == ("spread", 1, 1, 4)
    # the strips of swe at sizes the tests assemble, in both types; an
    # operator without far offsets, or whose strips would cut a warp, has one
    for M in (16, 32):
        A = swe.linforms(M=M, device="cpu").A
        assert A.offsets == _swe_offsets(M)
        for dtype in (torch.float64, torch.float32):
            assert kd.spmm_strip(A.shape[0], A.offsets, dtype) == M * M
    assert kd.spmm_strip(3 * 24 ** 2, _swe_offsets(24), torch.float32) == 3 * 24 ** 2
    A = heat.linforms(M=16, device="cpu").Emat
    assert kd.spmm_strip(A.shape[0], A.offsets, torch.float64) == A.shape[0]


def test_spmm_design_launches_each_design():
    """``spmm_design`` gives each design's launch whatever the plan picks:
    its least tile that holds the block, spread split to cover the card,
    and refuses a design that is not built."""
    n = 3 * 512 ** 2
    got = {d: kd.spmm_design(d, n, 8, torch.float64, 512 ** 2) for d in kd.DESIGNS}
    assert {d: (p.tile, p.split, p.depth, p.strip) for d, p in got.items()} == {
        "tile": (8, 8, 1, 512 ** 2), "spread": (2, 2, 4, 512 ** 2)}
    assert kd.spmm_design("spread", 9600, 8)[1:3] == (1, 1)
    assert kd.spmm_design("tile", n, 3)[1] == 4
    for design in ("tiled", "pair", "staged"):
        with pytest.raises(ValueError):
            kd.spmm_design(design, n, 8)


@pytest.mark.parametrize("dtype,rpt", [(torch.float64, 2), (torch.float32, 4)])
@pytest.mark.parametrize("design", ["tile", "spread"])
def test_register_schedules_give_the_twins_bits(design, dtype, rpt):
    """The tile and spread designs' schedules on every operator and width,
    on rows at an odd stride from an odd first element, in f64 and f32 at
    the kernel's rows a thread (and the tile design at a block of 256 rows
    and warps of 32, which cut the operators into many blocks and strips):
    the plain twin's bits."""
    for label, A in _operators().items():
        Ad = A if dtype == torch.float64 else A.astype(dtype)
        for B in BATCHES:
            for r in (rpt, 1) if design == "tile" else (rpt,):
                got, X = _product(label, design, B, dtype, r)
                want = kd.dia_spmm_torch(Ad.data, Ad.offsets, Ad.wrap, X)
                assert torch.equal(got, want), (label, B, r)


def test_emulations_match_jax():
    """Each schedule's product against the JAX package's ``dia_spmm`` (its
    XLA path) on the same operators and blocks, at swe M=16 and lkdv
    degree 3 M=100, B = 1, 3, 8, 9, 41."""
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
    from structurepreservingiterativesolvers_tpu.models import swe as jswe
    from structurepreservingiterativesolvers_tpu.ops import sparse as jsparse

    for label, jA in (("swe_M16_A", jswe.linforms(M=16).A),
                      ("lkdv_M100_deg3_A", jlkdv.linforms(M=100, degree=3).A)):
        A = _operators()[label]
        assert A.offsets == tuple(jA.offsets) and A.wrap == bool(jA.wrap)
        assert np.array_equal(A.data.numpy(), np.asarray(jA.data))
        spmm = jax.jit(jsparse.dia_spmm)
        for B in BATCHES:
            X = _product(label, "tile", B)[1]
            ref = np.asarray(spmm(jA, jnp.asarray(X.numpy())))
            for design in kd.DESIGNS:
                got, X_design = _product(label, design, B)
                assert torch.equal(X_design, X)
                torch_parity.close(got.numpy(), ref, 1e-14)
