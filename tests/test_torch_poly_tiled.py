"""The tiled design of the fused polynomial kernels (#3 and #4,
``csrc/poly_tiled.cu``) on the CPU, where the kernel cannot run:

* the host tile planner (``kernels/poly_apply.py::tile_plan``) on heat
  M=1024 (offsets one grid row and one grid column away, a ragged last
  tile), heat M=16, heat M=17 (odd M in f64: a DIA, so the flat design)
  and swe (a wrapped DIA), and its refusals where no tile fits;
* a plain PyTorch emulation of the kernel's schedule: the same tiles, halo
  points indexed by the flat index (a halo column outside [0, C) is a point
  of the neighbouring grid row), strip membership from the flat index, the
  regions shrinking by one point a side after each sweep, structural zeros
  outside [0, n), and the kernel's products: off the strips the nine cells
  of the 3 x 3 box in row-major order, zero where no offset lands; on the
  strips the offsets' chain and the strip sums.  It sums in the plain
  twin's order, so it gives the bits of ``cheb_apply_torch`` and
  ``neumann_apply_torch`` on heat M=16 and M=32 at degrees 1, 2, 3 and 8,
  with tiles narrower than the halo too: the test asks for equality, which
  a sum in another order misses.  It is a model of the kernel for these
  tests, used nowhere else.

The kernels themselves are held against the twins on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from structurepreservingiterativesolvers_torch import precond
from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
from structurepreservingiterativesolvers_torch.models import heat, swe

OMEGA = 0.8
DEGREES = (1, 2, 3, 8)


def _heat_offsets(M):
    C = M + 1
    return (M + 1) ** 2, C, (-C - 1, -C, -1, 0, 1, C, C + 1)


def test_plan_heat_M1024():
    n, C, offsets = _heat_offsets(1024)
    assert pa.split_offsets(offsets, C) == (
        (-1, -1), (-1, 0), (0, -1), (0, 0), (0, 1), (1, 0), (1, 1))
    for kind, degree, itemsize in (("cheb", 8, 8), ("neumann", 4, 8),
                                   ("cheb", 8, 4), ("cheb", 16, 8)):
        plan = pa.tile_plan(n, C, offsets, pa.sweeps(kind, degree), itemsize)
        assert plan is not None
        assert plan.sweeps == (degree if kind == "cheb" else degree - 1)
        assert plan.sweeps <= min(plan.tile_r, plan.tile_c)
        rows, cols = plan.tile_r + 2 * plan.sweeps, plan.tile_c + 2 * plan.sweeps
        assert plan.smem_bytes == (3 * rows * cols
                                   + plan.tile_r * plan.tile_c) * itemsize
        assert plan.smem_bytes <= pa.TILE_MAX_SMEM
        assert plan.blocks_per_sm >= 1
        assert plan.blocks_per_sm * (plan.smem_bytes + pa.SM_SMEM_PER_BLOCK) \
            <= pa.SM_SMEM
        assert plan.blocks_per_sm * pa.TILE_THREADS * pa.TILE_REGS <= pa.SM_REGS
        # 1025 = 16 * 64 + 1: the last tile row and column are ragged
        assert 1025 % plan.tile_r and 1025 % plan.tile_c
        assert plan.tiles == -(-1025 // plan.tile_r) * -(-1025 // plan.tile_c)
        assert plan == min(pa.tile_candidates(n, C, offsets, plan.sweeps,
                                              itemsize),
                           key=lambda p: (p.cost, -p.tile_r * p.tile_c,
                                          -p.tile_c))
        assert tuple(plan.c_args) == (plan.tile_r, plan.tile_c)


def test_plan_refuses_where_no_tile_fits():
    n, C, offsets = _heat_offsets(1024)
    # 64 sweeps: a halo of 64 needs a tile of 64, and three 192 x 192 f64
    # buffers are past a block's shared memory
    assert pa.tile_plan(n, C, offsets, 64, 8) is None
    # a halo wider than every tile side
    assert pa.tile_plan(n, C, offsets, max(pa.TILE_SIDES) + 1, 4) is None
    # heat M=16: the halo may not pass a grid row (17 columns)
    n16, C16, offsets16 = _heat_offsets(16)
    assert pa.tile_plan(n16, C16, offsets16, 17, 8) is not None
    assert pa.tile_plan(n16, C16, offsets16, 18, 8) is None
    # no grid: a row length that does not divide n, or fewer than 3 rows
    assert pa.tile_plan(n, C + 1, offsets, 8, 8) is None
    assert pa.tile_plan(2 * C, C, offsets, 8, 8) is None
    # offsets out of ascending order, or two grid rows away: the flat design
    assert pa.tile_plan(n, C, offsets[1:] + offsets[:1], 8, 8) is None
    assert pa.tile_plan(n, C, (-2 * C,) + offsets[1:], 8, 8) is None


def test_dispatch_by_shape():
    """The design follows from the operator's form and the degree alone:
    tiled on heat's stencil, flat on a DIA (heat M=17 in f64, swe) and where
    no tile fits; on CPU tensors the wrappers give the plain twins."""
    s16, s17, sw = (heat.linforms(M=16, device="cpu"),
                    heat.linforms(M=17, device="cpu"),
                    swe.linforms(M=16, device="cpu"))
    assert s16.A.grid_c == 17 and not hasattr(s17.A, "const")
    for kind in ("cheb", "neumann"):
        for dtype in (torch.float64, torch.float32):
            assert pa.poly_design(s16.A, kind, 8, dtype) == "tiled"
            assert pa.poly_design(s17.A, kind, 8, dtype) == "flat"
            assert pa.poly_design(sw.A, kind, 8, dtype) == "flat"
    assert pa.poly_design(s16.A, "cheb", pa.MAX_DEGREE, torch.float64) == "flat"
    plan = pa.poly_plan(s16.A, "cheb", 8, torch.float64)
    assert pa.poly_plan(s16.A, "cheb", 8, torch.float64) is plan  # cached
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(289))
    pre = precond.chebyshev(s16.A, degree=8)
    theta = 0.5 * (pre.lmax + pre.lmin)
    delta = 0.5 * (pre.lmax - pre.lmin)
    args = (s16.A, 8, theta, delta, theta / delta, v)
    assert torch.equal(pa.cheb_apply(*args), pa.cheb_apply_torch(*args))
    with pytest.raises(ValueError, match="CUDA"):
        pa.cheb_apply_tiled_cuda(s16.A, plan, 8, theta, delta, theta / delta,
                                 v)
    assert (pa.cheb_apply_tiled_cuda.launches, pa.cheb_apply_flat_cuda.launches,
            pa.cheb_apply_cuda.launches) == (0, 0, 0)


def _emulate(A, kind, degree, v, tile_r, tile_c, theta=None, delta=None,
             sigma=None, dinv=None, omega=None):
    """p(A) v by the tiled kernel's schedule on tiles of tile_r x tile_c,
    summing its products as it does."""
    n = v.shape[0]
    C = A.grid_c
    R = n // C
    steps = pa.split_offsets(A.offsets, C)
    cells = dict(zip(steps, A.const))
    halo = pa.sweeps(kind, degree)
    top, bot, left, right = A.strips
    if kind == "cheb":
        c0, coef_a, coef_b = pa.cheb_coefficients(degree, delta, sigma)
    y = torch.full_like(v, float("nan"))
    for ir in range(0, R, tile_r):
        for ic in range(0, C, tile_c):
            th, tw = min(tile_r, R - ir), min(tile_c, C - ic)
            rows, cols = th + 2 * halo, tw + 2 * halo
            gr = (ir - halo + torch.arange(rows))[:, None].expand(rows, cols)
            gc = (ic - halo + torch.arange(cols))[None, :].expand(rows, cols)
            wrap = (gc >= C).long() - (gc < 0).long()  # one grid row over
            gr, gc = gr + wrap, gc - wrap * C
            f = gr * C + gc
            valid = (gr >= 0) & (gr < R)
            fi = f.clamp(0, n - 1)
            zero = torch.zeros((rows, cols), dtype=v.dtype)
            vv = torch.where(valid, v[fi], zero)

            def product(src, lo):
                """Off the strips the nine cells of the 3 x 3 box in
                row-major order, zero where no offset lands; on a strip the
                offsets' chain and the strip sums, as stencil_sum adds
                them."""
                reg = (slice(lo, rows - lo), slice(lo, cols - lo))

                def shifted(dr, dc):
                    return src[lo + dr:rows - lo + dr, lo + dc:cols - lo + dc]

                box = torch.zeros_like(src[reg])
                for dr in (-1, 0, 1):
                    for dc in (-1, 0, 1):
                        box = box + cells.get((dr, dc), 0.0) * shifted(dr, dc)
                chain = torch.zeros_like(box)
                for c, (dr, dc) in zip(A.const, steps):
                    chain = chain + c * shifted(dr, dc)
                fr, rr, cc, ok = f[reg], gr[reg], gc[reg], valid[reg]
                members = (ok & (fr < C), ok & (fr >= n - C), ok & (cc == 0),
                           ok & (cc == C - 1))
                where = (fr.clamp(0, C - 1), (fr - (n - C)).clamp(0, C - 1),
                         rr.clamp(0, R - 1), rr.clamp(0, R - 1))
                parts = []
                for strip, member, at in zip((top, bot, left, right), members,
                                             where):
                    part = torch.zeros_like(box)
                    for d, (dr, dc) in enumerate(steps):
                        part = part + torch.where(member, strip[d][at],
                                                  zero[reg]) * shifted(dr, dc)
                    parts.append(part)
                on_strip = members[0] | members[1] | members[2] | members[3]
                return torch.where(on_strip, chain + (((parts[0] + parts[1])
                                                       + parts[2]) + parts[3]),
                                   box)

            inner = (slice(halo, halo + th), slice(halo, halo + tw))
            if kind == "cheb":
                b0 = torch.where(valid, vv / theta, zero)
                b1, rb, xb = zero.clone(), vv.clone(), zero.clone()
            else:
                db = torch.where(valid, dinv[fi], zero)
                b0 = torch.where(valid, omega * (db * vv), zero)
                b1, ab = zero.clone(), zero.clone()
            if halo == 0:
                y[f[inner].reshape(-1)] = b0[inner].reshape(-1)
            for k in range(halo):
                src, dst = (b1, b0) if k & 1 else (b0, b1)
                lo = k + 1
                reg = (slice(lo, rows - lo), slice(lo, cols - lo))
                ok = valid[reg]
                prod = product(src, lo)
                if kind == "cheb":
                    if k == 0:
                        xi = src[reg]
                        ri = rb[reg] - prod
                        new = c0 * ri
                    else:
                        di = src[reg]
                        xi = xb[reg] + di
                        ri = rb[reg] - prod
                        new = coef_a[k - 1] * di + coef_b[k - 1] * ri
                    out = xi + new
                    xb[reg] = torch.where(ok, xi, xb[reg])
                    rb[reg] = torch.where(ok, ri, rb[reg])
                else:
                    zc = src[reg]
                    new = zc - omega * (db[reg] * prod)
                    out = (zc if k == 0 else ab[reg]) + new
                    ab[reg] = torch.where(ok, out, ab[reg])
                dst[reg] = torch.where(ok, new, dst[reg])
                if k == halo - 1:  # the region is the interior
                    y[f[inner].reshape(-1)] = out.reshape(-1)
    assert not bool(torch.isnan(y).any()), "a point no tile wrote"
    return y


@pytest.mark.parametrize("M,tiles", [
    (16, ((4, 4), (5, 3), (8, 16), (17, 17))),
    (32, ((6, 7), (16, 16))),
])
def test_emulated_schedule_matches_the_twins(M, tiles):
    """Tiles narrower than the halo, ragged last tiles and a tile holding
    the whole grid give the plain twins' y."""
    s = heat.linforms(M=M, device="cpu")
    A = s.A
    pre = precond.chebyshev(A, degree=8)
    theta = 0.5 * (pre.lmax + pre.lmin)
    delta = 0.5 * (pre.lmax - pre.lmin)
    dinv = precond.neumann(A, degree=4, omega=OMEGA).dinv
    v = torch.as_tensor(np.random.default_rng(M).standard_normal(A.shape[0]))
    for degree in DEGREES:
        cheb = pa.cheb_apply_torch(A, degree, theta, delta, theta / delta, v)
        neu = pa.neumann_apply_torch(A, dinv, degree, OMEGA, v)
        for tile_r, tile_c in tiles:
            got = _emulate(A, "cheb", degree, v, tile_r, tile_c, theta=theta,
                           delta=delta, sigma=theta / delta)
            assert torch.equal(got, cheb), (degree, tile_r, tile_c)
            got = _emulate(A, "neumann", degree, v, tile_r, tile_c, dinv=dinv,
                           omega=OMEGA)
            assert torch.equal(got, neu), (degree, tile_r, tile_c)
