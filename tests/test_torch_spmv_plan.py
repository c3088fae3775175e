"""The redesigned SpMV kernels (#1 DIA with its live plan, #2 stencil on 2-D
tiles) on the CPU, where the kernels cannot run:

* #1: the live plan (``kernels/dia_spmv.py::live_plan``) against
  ``(data != 0).any`` per chunk, on swe M=16 and M=32, lkdv degree 3 M=100,
  a ragged non-wrapping n, an all-zero diagonal, a partly zero chunk and 64
  diagonals; a plain emulation of the kernel's segmented product (each
  chunk adds only its live diagonals, in ascending order), equal to the
  plain twin ``dia_spmv_torch`` on finite x and held to the JAX package's
  ``ops/sparse.py::dia_spmv`` (its XLA path, f64) at swe M=16; the
  documented non-finite behaviour; and the plan kept by the ``DIA``, with
  the design its live share picks;
* #2: the tile planner (``kernels/stencil_spmv.py::stencil_plan``) and a
  plain emulation of the tile schedule: interior tiles of TX columns by
  TY x RUN rows whose points read the 3 x 3 window at flat addresses and
  sum its present cells in row-major order, and the strip points apart
  through the flat shifted reads and the strip sums.  It gives the bits of
  ``stencil_spmv_torch`` at heat M=16 and M=17, at the planned tile and at
  small tiles that cut the grid into many.

The emulations are models of the kernels for these tests, used nowhere
else; the kernels themselves are held against the twins on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks
from structurepreservingiterativesolvers_torch.models import heat, lkdv, swe
from structurepreservingiterativesolvers_torch.ops.sparse import DIA


def _dia_cases():
    """label -> (data, offsets, wrap): the operators of the main paths at
    small sizes, and the edge cases of the plan."""
    rng = np.random.default_rng(7)
    out = {}
    for M in (16, 32):
        A = swe.linforms(M=M, device="cpu").A
        out[f"swe_M{M}"] = (A.data, A.offsets, A.wrap)
    A = lkdv.linforms(M=100, degree=3, device="cpu").A
    out["lkdv_deg3_M100"] = (A.data, A.offsets, A.wrap)
    # ragged n (1000 = 15 chunks of 64 and 40 rows), an all-zero diagonal,
    # and a chunk that is zero only in part
    data = torch.as_tensor(rng.standard_normal((5, 1000)))
    data[2] = 0.0
    data[1, 130:170] = 0.0
    data[3, 64:128] = 0.0
    out["ragged"] = (data, (-3, -1, 0, 1, 3), False)
    # 64 diagonals (bit 63 is the sign bit), one chunk of each left empty
    data = torch.as_tensor(rng.standard_normal((64, 4096)))
    for d in range(64):
        data[d, 64 * d:64 * (d + 1)] = 0.0
    out["ndiag64"] = (data, tuple(range(-32, 32)), True)
    return out


def _segmented(data, offsets, wrap, x, plan):
    """The kernel's product as a plain emulation: per chunk, y sums only
    the diagonals live in it, in ascending order; a skipped diagonal is not
    multiplied at all."""
    words, chunk = plan.words, plan.chunk
    n = x.shape[0]
    word = words.repeat_interleave(chunk)[:n]
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        live = ((word >> d) & 1).bool()
        y = torch.where(live, y + data[d] * kd.shift(x, int(off), wrap), y)
    return y


def test_live_plan_marks_nonzero_chunks():
    for label, (data, offsets, wrap) in _dia_cases().items():
        ndiag, n = data.shape
        for chunk in (kd.LIVE_CHUNK, 64, 256, 1024):
            plan = kd.live_plan(data, chunk)
            assert plan.chunk == chunk and plan.words.dtype == torch.int64
            nchunks = -(-n // chunk)
            assert tuple(plan.words.shape) == (nchunks,)
            nz = np.asarray(data != 0)
            live_rows = 0
            for c, word in enumerate(plan.words.tolist()):
                want = nz[:, c * chunk:(c + 1) * chunk].any(axis=1)
                got = [(word >> d) & 1 == 1 for d in range(ndiag)]
                assert got == want.tolist(), (label, chunk, c)
                live_rows += int(want.sum()) * nz[:, c * chunk:
                                                  (c + 1) * chunk].shape[1]
            assert plan.share == live_rows / (ndiag * n), (label, chunk)
    with pytest.raises(ValueError):
        kd.live_plan(data, 96)


def test_segmented_product_equals_plain_twin():
    """On finite x the segmented product gives the plain twin's bits: a
    skipped term has a zero coefficient over its whole chunk."""
    rng = np.random.default_rng(8)
    for label, (data, offsets, wrap) in _dia_cases().items():
        for dtype in (torch.float64, torch.float32):
            d = data.to(dtype)
            x = torch.as_tensor(rng.standard_normal(d.shape[1])).to(dtype)
            plan = kd.live_plan(d, kd.live_chunk(dtype))
            y = _segmented(d, offsets, wrap, x, plan)
            assert torch.equal(y, kd.dia_spmv_torch(d, offsets, wrap, x)), (
                label, dtype)


def test_segmented_product_matches_jax_swe_M16():
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.models import swe as jswe
    from structurepreservingiterativesolvers_tpu.ops import sparse as jsp

    Aj = jswe.linforms(M=16).A
    data, offsets, wrap = torch_parity.dia_triple(Aj)
    x = np.random.default_rng(9).standard_normal(Aj.shape[0])
    yj = np.asarray(jax.jit(jsp.dia_spmv)(Aj, jnp.asarray(x)))
    d = torch.tensor(data, dtype=torch.float64)
    plan = kd.live_plan(d, kd.live_chunk(torch.float64))
    # swe holds 70% zeros: the plan skips some chunk of every field block
    assert int(sum(bin(w & (2**64 - 1)).count("1")
                   for w in plan.words.tolist())) < len(offsets) * len(plan.words)
    y = _segmented(d, offsets, wrap, torch.as_tensor(x), plan).numpy()
    assert torch_parity.rel_max(y, yj) <= 1e-14


def test_segmented_product_nonfinite_x():
    """An Inf or NaN of x that only zero segments read does not reach y in
    the segmented product; the plain twin spreads it.  One that a live
    coefficient reads reaches y in both."""
    data = torch.ones(3, 256, dtype=torch.float64)
    data[2, :128] = 0.0  # offset +1 is dead over the first two chunks
    offsets = (-1, 0, 1)
    plan = kd.live_plan(data, 64)
    x = torch.ones(256, dtype=torch.float64)
    x[10] = float("nan")  # read by offset +1 at row 9 only
    y = _segmented(data, offsets, False, x, plan)
    plain = kd.dia_spmv_torch(data, offsets, False, x)
    assert bool(torch.isnan(plain[9])) and not bool(torch.isnan(y[9]))
    assert bool(torch.isnan(y[10]) & torch.isnan(y[11]))  # offsets 0, -1
    assert int(torch.isnan(y).sum()) == 2 and int(torch.isnan(plain).sum()) == 3


def test_dia_keeps_its_plan():
    """The plan is built once per operator and kept with it; a DIA with new
    data starts without one.  A product on the CPU builds none.  The plan
    pays (the live design runs) on swe, which skips most segments, and not
    on heat, whose every segment but the boundary rows' is live."""
    A = swe.linforms(M=16, device="cpu").A
    x = torch.ones(A.shape[0], dtype=torch.float64)
    A @ x
    assert A._plan is None
    plan = A.live()
    assert A.live() is plan and plan.chunk == kd.live_chunk(torch.float64)
    assert torch.equal(plan.words, kd.live_plan(A.data, plan.chunk).words)
    assert plan.pays and plan.share < 0.5
    B = A.astype(torch.float32)
    assert B._plan is None and B.live().chunk == kd.live_chunk(torch.float32)
    assert A == DIA(A.data, A.offsets, A.shape, A.wrap)  # not compared
    H = heat.linforms(M=64, device="cpu").A.dia
    assert H.live().share > 1 - kd.LIVE_MIN_SKIP and not H.live().pays


def _heat_stencil(M, dtype=torch.float64):
    """heat's operator as a Stencil with strips: M=17 assembles as one in
    f32, and is then cast."""
    A = heat.linforms(M=M, device="cpu",
                      dtype=torch.float64 if M % 2 == 0 else torch.float32).A
    assert A.grid_c == M + 1
    return A.astype(dtype)


def test_stencil_tile_planner():
    for M in (16, 17, 1024):
        C = M + 1
        n, offsets = C * C, (-C - 1, -C, -1, 0, 1, C, C + 1)
        plan = ks.stencil_plan(n, C, offsets, False)
        assert (plan.tx, plan.ty, plan.run) == ks.TILE
        assert len(ks.stencil_tiles(n, C, offsets, False)) == len(ks.TILES)
        # no strips, a periodic operator: flat
        assert ks.stencil_plan(n, 0, offsets, False) is None
        assert ks.stencil_plan(n, C, offsets, True) is None
    C = 1025
    n = C * C
    for offsets in ((-2 * C, -C - 1, -1, 0, 1, C + 1, 2 * C),  # two rows
                    (-C - 2, -1, 0, 1, C + 2),  # two columns
                    (-C, -1, 0, 1, C)[::-1]):  # not ascending
        assert ks.stencil_plan(n, C, offsets, False) is None
    assert ks.stencil_plan(2 * 1000, 1000, (-1, 0, 1), False) is None  # R < 3
    for tx, ty, run in ks.TILES:
        assert tx % 32 == 0 and tx * ty <= 256 and run in (4, 8, 16)


def _tiled(S, x, tile):
    """The tiled kernel's schedule and products as a plain emulation; every
    point is written once."""
    const, offsets, C = S.const, S.offsets, S.grid_c
    n = x.shape[0]
    R = n // C
    tx, ty, run = tile
    box = [(dr, dc, c) for (dr, dc), c in zip(ks.split_offsets(offsets, C),
                                              const)]
    y = torch.full_like(x, float("nan"))
    written = torch.zeros(n, dtype=torch.int64)
    for bj in range(-(-(C - 2) // tx)):
        for bi in range(-(-(R - 2) // (ty * run))):
            for t in range(ty):
                r0 = 1 + (bi * ty + t) * run
                cols = 1 + bj * tx + torch.arange(tx)
                cols = cols[cols <= C - 2]
                for r in range(r0, min(r0 + run, R - 1)):
                    f = r * C + cols
                    acc = torch.zeros(len(cols), dtype=x.dtype)
                    for dr, dc, c in box:  # row-major: ascending offsets
                        acc = acc + c * x[f + dr * C + dc]
                    y[f] = acc
                    written[f] += 1
    # the strip points, in the kernel's order of threads
    q = torch.arange(2 * C + 2 * (R - 2))
    r = torch.where(q < C, 0, torch.where(q < 2 * C, R - 1, torch.where(
        q < 2 * C + R - 2, 1 + q - 2 * C, 1 + q - 2 * C - (R - 2))))
    col = torch.where(q < C, q, torch.where(q < 2 * C, q - C, torch.where(
        q < 2 * C + R - 2, 0, C - 1)))
    f = r * C + col
    acc = torch.zeros(len(f), dtype=x.dtype)
    xs = []
    for c, off in zip(const, offsets):
        j = f + off
        xs.append(torch.where((j >= 0) & (j < n), x[j.clamp(0, n - 1)], 0.0))
        acc = acc + c * xs[-1]
    top, bot, left, right = S.strips
    sums = []
    for strip, on, at in ((top, r == 0, col), (bot, r == R - 1, col),
                          (left, col == 0, r), (right, col == C - 1, r)):
        s = torch.zeros(len(f), dtype=x.dtype)
        for d in range(len(offsets)):
            s = s + torch.where(on, strip[d][at] * xs[d], 0.0)
        sums.append(s)
    y[f] = acc + (((sums[0] + sums[1]) + sums[2]) + sums[3])
    written[f] += 1
    assert bool((written == 1).all())
    return y


def test_stencil_tile_emulation_equals_plain_twin():
    rng = np.random.default_rng(10)
    for M in (16, 17):
        for dtype in (torch.float64, torch.float32):
            S = _heat_stencil(M, dtype)
            x = torch.as_tensor(rng.standard_normal(S.shape[0])).to(dtype)
            plain = ks.stencil_spmv_torch(S.const, S.offsets, S.wrap,
                                          S.grid_c, S.strips, x)
            for tile in (ks.TILE, (2, 2, 1), (4, 1, 3)):
                assert torch.equal(_tiled(S, x, tile), plain), (M, dtype, tile)
