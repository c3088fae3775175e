"""Tests of the PyTorch port that need an NVIDIA card: the CUDA DIA kernel
(its live and dense designs), its batched kernel (every design, and the one
its plan picks) and stencil kernel (its tiled and flat designs), the fused Chebyshev and Neumann applies (both designs, and
the dispatch between them) and the fused CGS2 update against their plain
twins, and solves on the card (lkdv, heat with
the structured AMG, swe with the fused orthogonalisation and the skew-normal
Chebyshev) against the same solves on the CPU.  They skip where no card is
present.

This file imports no JAX, so it also runs on the machine with the card,
which has none (``--noconftest`` keeps the JAX set-up of ``conftest.py``
out)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
    dia_spmv,
    dia_spmv_cuda,
    dia_spmv_torch,
)
from structurepreservingiterativesolvers_torch.kernels.stencil_spmv import (
    stencil_spmv,
    stencil_spmv_cuda,
    stencil_spmv_torch,
)

# the same multiply-adds in the same diagonal order; the kernel's fused
# multiply-adds round once where the plain version rounds twice
RTOL = {torch.float64: 1e-14, torch.float32: 1e-6}

CASES = [
    # n, offsets, wrap: ragged n without wrap, spans wider than 128 rows,
    # both signs of offset, and an offset of n - 1
    (1000, (-3, -1, 0, 1, 3), False),
    (1024, (-130, -1, 0, 1, 130), True),
    (777, (-256, 0, 256), False),
    (300, (-299, -7, 0, 7, 299), True),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,offsets,wrap", CASES)
def test_kernel_matches_plain(dtype, n, offsets, wrap):
    _card()
    g = torch.Generator().manual_seed(n)
    data = torch.randn(len(offsets), n, generator=g, dtype=dtype).cuda()
    x = torch.randn(n, generator=g, dtype=dtype).cuda()
    before = dia_spmv_cuda.launches
    y = dia_spmv(data, offsets, wrap, x)
    torch.cuda.synchronize()
    assert dia_spmv_cuda.launches == before + 1
    ref = dia_spmv_torch(data, offsets, wrap, x)
    assert float((y - ref).abs().max() / ref.abs().max()) <= RTOL[dtype]


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _card()
    data = torch.randn(3, 64, dtype=torch.float64, device="cuda")
    x = torch.randn(64, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        dia_spmv(data, (-1, 0, 1), True, x.float())
    with pytest.raises(ValueError):
        dia_spmv(data, (-1, 0, 64), True, x)
    with pytest.raises(ValueError):
        dia_spmv(data[:, ::2], (-1, 0, 1), True, x[::2])
    with pytest.raises(ValueError):
        dia_spmv(data, (-1, 0, 1), True, x.cpu())


@pytest.mark.cuda
def test_cgmres_on_card_matches_cpu():
    """lkdv CGMRES on the card takes the same steps as on the CPU, goes
    through the kernel, and lands on the same iterate to 1e-8."""
    _card()
    from structurepreservingiterativesolvers_torch.models import lkdv
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    out = {}
    for device in ("cpu", "cuda"):
        s = lkdv.linforms(M=50, degree=1, device=device)
        before = dia_spmv_cuda.launches
        x, info = cgmres(s.A, s.b, k=30, tol=1e-10, constraints=s.constraints())
        out[device] = (x.cpu(), info, dia_spmv_cuda.launches - before)
    (xc, ic, lc), (xg, ig, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg > 0
    for key in ("steps", "constrained_steps", "safety"):
        assert ig[key] == ic[key]
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-8
    assert ig["deviation"] <= 1e-10


def _live_operators(case):
    """label -> a DIA on the card of one case of the live design: the swe
    M=512 operator (70% zeros), lkdv degree 3 M=100, every DIA of heat M=64
    with its AMG hierarchy, a ragged n with zero diagonals and chunks, and
    64 diagonals."""
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA

    if case == "swe_M512":
        from structurepreservingiterativesolvers_torch.models import swe

        return {case: swe.linforms(M=512, device="cuda").A}
    if case == "lkdv":
        from structurepreservingiterativesolvers_torch.models import lkdv

        s = lkdv.linforms(M=100, degree=3, device="cuda")
        return {"lkdv A": s.A, "lkdv Mmat": s.Mmat}
    if case == "heat_levels":
        from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
            default_pre_builder,
        )
        from structurepreservingiterativesolvers_torch.models import heat

        s = heat.linforms(M=64, device="cuda")
        ops = {"heat A": s.A.dia, "heat Mmat": s.Mmat, "heat Emat": s.Emat}
        for i, L in enumerate(default_pre_builder("heat")(s).levels):
            ops[f"level {i} A"] = L.A
            if L.P is not None:
                ops[f"level {i} S_P"], ops[f"level {i} S_R"] = L.P.S, L.R.S
        return ops
    g = torch.Generator().manual_seed(5)
    if case == "ragged":
        data = torch.randn(5, 1001, generator=g, dtype=torch.float64)
        data[2] = 0.0
        data[1, 130:170] = 0.0
        data[3, 64:256] = 0.0
        return {case: DIA(data.cuda(), (-3, -1, 0, 1, 3), (1001, 1001), False)}
    data = torch.randn(64, 8192, generator=g, dtype=torch.float64)
    for d in range(64):
        data[d, 128 * d:128 * (d + 1)] = 0.0
    return {case: DIA(data.cuda(), tuple(range(-40, 24)), (8192, 8192), True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["swe_M512", "lkdv", "heat_levels", "ragged",
                                  "ndiag64"])
def test_live_dia_matches_plain_and_dense(case, dtype):
    """The live design with A's plan, built once: within the bound of the
    plain twin, the dense design's bits, and bit-equal when repeated.
    ``A @ x`` gives the same bits in the design the plan picks: live where
    it pays (swe, which skips most segments), dense where it does not
    (heat, live but at the boundary rows)."""
    _card()
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

    counters = (kd.dia_spmv_live_cuda, kd.dia_spmv_dense_cuda, dia_spmv_cuda)
    for label, A in _live_operators(case).items():
        A = A.astype(dtype)
        x = torch.randn(A.shape[0], generator=torch.Generator().manual_seed(3),
                        dtype=dtype).cuda()
        plan = A.live()
        assert A.live() is plan  # built once
        if case in ("swe_M512", "heat_levels"):
            assert plan.pays == (case == "swe_M512"), (label, plan.share)
        before = [c.launches for c in counters]
        y = kd.dia_spmv_live_cuda(A.data, A.offsets, A.wrap, plan, x)
        again = kd.dia_spmv_live_cuda(A.data, A.offsets, A.wrap, plan, x)
        dense = dia_spmv(A.data, A.offsets, A.wrap, x)
        product = A @ x
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == (
            [3, 1, 4] if plan.pays else [2, 2, 4]), label
        assert A._launch.design == ("live" if plan.pays else "dense")
        assert torch.equal(product, y), label
        ref = dia_spmv_torch(A.data, A.offsets, A.wrap, x)
        rel = float((y - ref).abs().max() / ref.abs().max())
        assert rel <= RTOL[dtype], (label, rel)
        assert torch.equal(y, dense) and torch.equal(y, again), label


@pytest.mark.cuda
def test_live_dia_nonfinite_and_refusals():
    """A NaN of x that only a zero segment reads does not reach y in the
    live design; the dense design spreads it.  A plan of the wrong shape,
    device or chunk is refused."""
    _card()
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

    data = torch.ones(3, 512, dtype=torch.float64, device="cuda")
    data[2, :256] = 0.0  # offset +1 is dead over the first chunks
    plan = kd.live_plan(data, 128)
    x = torch.ones(512, dtype=torch.float64, device="cuda")
    x[10] = float("nan")
    y = kd.dia_spmv_live_cuda(data, (-1, 0, 1), False, plan, x)
    dense = kd.dia_spmv_dense_cuda(data, (-1, 0, 1), False, x)
    torch.cuda.synchronize()
    assert int(torch.isnan(y).sum()) == 2 and not bool(torch.isnan(y[9]))
    assert int(torch.isnan(dense).sum()) == 3
    with pytest.raises(ValueError):  # chunks of fewer rows than a warp's
        kd.dia_spmv_live_cuda(data, (-1, 0, 1), False,
                              kd.live_plan(data, 32), x)
    with pytest.raises(ValueError):  # a plan of another operator
        kd.dia_spmv_live_cuda(data, (-1, 0, 1), False,
                              kd.live_plan(data[:, :256], 128), x)
    with pytest.raises(ValueError):
        kd.dia_spmv_live_cuda(data, (-1, 0, 1), False,
                              kd.LivePlan(plan.words.cpu(), 128, 1.0), x)


# R, C, offsets, wrap, strips: a 9-point grid stencil with boundary strips
# on a ragged n (37 * 29 = 1073), the same on a grid row longer than a
# block, an exactly constant periodic operator, and a constant one without
# wrap on a ragged n
STENCIL_CASES = [
    (37, 29, None, False, True),
    (5, 300, None, False, True),
    (1, 1000, (-130, -1, 0, 1, 130), True, False),
    (1, 777, (-256, -3, 0, 3, 256), False, False),
]


def _stencil_operands(R, C, offsets, wrap, strips, dtype):
    """Constants, and strip residuals with zeros at the corner grid rows of
    the left and right strips (as ``maybe_stencil`` leaves them)."""
    g = torch.Generator().manual_seed(R * C)
    offsets = offsets or (-C - 1, -C, -1, 0, 1, C, C + 1)
    nd = len(offsets)
    const = tuple(torch.randn(nd, generator=g, dtype=torch.float64).tolist())
    if not strips:
        return const, offsets, 0, None
    top, bot = (torch.randn(nd, C, generator=g, dtype=dtype) for _ in range(2))
    left, right = (torch.randn(nd, R, generator=g, dtype=dtype) for _ in range(2))
    for s in (left, right):
        s[:, 0] = s[:, R - 1] = 0.0
    return const, offsets, C, tuple(t.cuda() for t in (top, bot, left, right))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,C,offsets,wrap,strips", STENCIL_CASES)
def test_stencil_kernel_matches_plain(dtype, R, C, offsets, wrap, strips):
    _card()
    const, offsets, grid_c, st = _stencil_operands(R, C, offsets, wrap,
                                                   strips, dtype)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(R * C, generator=g, dtype=dtype).cuda()
    before = stencil_spmv_cuda.launches
    y = stencil_spmv(const, offsets, wrap, grid_c, st, x)
    torch.cuda.synchronize()
    assert stencil_spmv_cuda.launches == before + 1
    ref = stencil_spmv_torch(const, offsets, wrap, grid_c, st, x)
    assert float((y - ref).abs().max() / ref.abs().max()) <= RTOL[dtype]


@pytest.mark.cuda
def test_stencil_kernel_refuses_what_it_does_not_take():
    _card()
    const, offsets, C, st = _stencil_operands(37, 29, None, False, True,
                                              torch.float64)
    x = torch.randn(37 * 29, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        stencil_spmv(const, offsets, False, C, st, x.float())
    with pytest.raises(ValueError):  # strips on a periodic operator
        stencil_spmv(const, offsets, True, C, st, x)
    with pytest.raises(ValueError):  # a grid row length that does not tile n
        stencil_spmv(const, offsets, False, C + 1, st, x)
    with pytest.raises(ValueError):
        stencil_spmv(const, offsets, False, C, (st[2], st[1], st[0], st[3]), x)
    with pytest.raises(ValueError):
        stencil_spmv(const, offsets, False, C, st,
                     torch.randn(2 * 37 * 29, dtype=torch.float64,
                                 device="cuda")[::2])
    with pytest.raises(ValueError):
        stencil_spmv(const[:-1], offsets, False, C, st, x)
    with pytest.raises(ValueError):
        stencil_spmv_cuda(const, offsets, False, C, st, x.cpu())


@pytest.mark.cuda
def test_heat_amg_cgmres_on_card_matches_cpu():
    """heat M=32 CGMRES with the structured AMG on the card takes the same
    steps as on the CPU, with its safety, through both kernels."""
    _card()
    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import heat

    out = {}
    for device in ("cpu", "cuda"):
        s = heat.linforms(M=32, device=device)
        pre = default_pre_builder("heat")(s)
        before = (dia_spmv_cuda.launches, stencil_spmv_cuda.launches)
        x, info = wrappers.cgmres_wrapper(s, k=20, tol=1e-7, pre=pre)
        torch.cuda.synchronize()
        out[device] = (x.cpu(), info, dia_spmv_cuda.launches - before[0],
                       stencil_spmv_cuda.launches - before[1])
    (xc, ic, dc, sc), (xg, ig, dg, sg) = out["cpu"], out["cuda"]
    assert dc == sc == 0 and dg > 0 and sg > 0
    for key in ("steps", "constrained_steps", "safety"):
        assert ig[key] == ic[key]
    assert ig["safety"] is True and ig["deviation"] <= 1e-10
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-8


# the fused polynomial applies (kernels #3 and #4): the same recurrence in
# the same order as the plain twins, each of the p products summed as the
# SpMV kernels sum it; the bounds are on max|Δy| / max|y| after p steps
POLY_RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
# (name, degree) of each apply; degree 3 runs both ping-pong buffers
POLY_APPLIES = [("cheb", 1), ("cheb", 2), ("cheb", 3), ("cheb", 8),
                ("neumann", 1), ("neumann", 2), ("neumann", 3),
                ("neumann", 4)]
# a DIA on a ragged n without wrap and one with wrap, a stencil with strips
# on a ragged grid, and an exactly constant periodic stencil
POLY_FORMS = ["dia_ragged", "dia_wrap", "stencil_strips", "stencil_periodic"]


def _poly_operator(form, dtype):
    """A diagonally dominant operator of the port on the card, so that p
    steps of either recurrence stay bounded, and its inverse diagonal."""
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA
    from structurepreservingiterativesolvers_torch.ops.stencil import Stencil

    g = torch.Generator().manual_seed(POLY_FORMS.index(form))
    if form.startswith("dia"):
        n, offsets, wrap = ((1000, (-3, -1, 0, 1, 3), False)
                            if form == "dia_ragged"
                            else (1024, (-130, -1, 0, 1, 130), True))
        data = 0.2 * torch.randn(len(offsets), n, generator=g, dtype=dtype)
        data[offsets.index(0)] += 2.0
        A = DIA(data=data.cuda(), offsets=offsets, shape=(n, n), wrap=wrap)
        return A, 1.0 / A.data[offsets.index(0)]
    R, C, offsets, wrap, strips = ((37, 29, None, False, True)
                                   if form == "stencil_strips"
                                   else (1, 1000, (-130, -1, 0, 1, 130), True,
                                         False))
    const, offsets, grid_c, st = _stencil_operands(R, C, offsets, wrap, strips,
                                                   dtype)
    const = tuple(0.2 * c + (2.0 if o == 0 else 0.0)
                  for c, o in zip(const, offsets))
    if st is not None:
        st = tuple(0.2 * s for s in st)
    n = R * C
    dia = DIA(data=torch.zeros(len(offsets), n, dtype=dtype, device="cuda"),
              offsets=offsets, shape=(n, n), wrap=wrap)
    A = Stencil(dia=dia, const=const, top_vals=st and st[0],
                bot_vals=st and st[1], left_vals=st and st[2],
                right_vals=st and st[3], grid_c=grid_c)
    diag = torch.full((n,), const[offsets.index(0)], dtype=dtype,
                      device="cuda")
    return A, 1.0 / diag


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", POLY_FORMS)
@pytest.mark.parametrize("kind,degree", POLY_APPLIES)
def test_poly_kernels_match_plain(dtype, form, kind, degree):
    _card()
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa

    A, dinv = _poly_operator(form, dtype)
    v = torch.randn(A.shape[0], generator=torch.Generator().manual_seed(3),
                    dtype=dtype).cuda()
    if kind == "cheb":
        lmin, lmax = 1.0, 3.5
        theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
        args = (A, degree, theta, delta, theta / delta, v)
        kernel, plain, counter = pa.cheb_apply, pa.cheb_apply_torch, pa.cheb_apply_cuda
    else:
        args = (A, dinv, degree, 0.8, v)
        kernel, plain = pa.neumann_apply, pa.neumann_apply_torch
        counter = pa.neumann_apply_cuda
    before = counter.launches
    y = kernel(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = plain(*args)
    assert y.dtype == dtype and bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max() / ref.abs().max()) <= POLY_RTOL[dtype]


@pytest.mark.cuda
def test_poly_builders_fuse_on_the_card():
    """chebyshev() and neumann() of a card operator take the fused kernels,
    and give what the unfused chain of SpMV kernels gives; fused=False keeps
    the chain."""
    _card()
    from structurepreservingiterativesolvers_torch import precond
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.models import heat

    s = heat.linforms(M=32, device="cuda")
    v = torch.randn(s.b.shape[0], generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64).cuda()
    for build in (lambda **kw: precond.chebyshev(s.A, degree=8, **kw),
                  lambda **kw: precond.neumann(s.A, degree=4, **kw)):
        fused, chain = build(), build(fused=False)
        assert fused.fused is True and chain.fused is False
        before = (pa.cheb_apply_cuda.launches + pa.neumann_apply_cuda.launches,
                  stencil_spmv_cuda.launches)
        y = fused(v)
        torch.cuda.synchronize()
        assert (pa.cheb_apply_cuda.launches + pa.neumann_apply_cuda.launches,
                stencil_spmv_cuda.launches) == (before[0] + 1, before[1])
        ref = chain(v)
        assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-13


@pytest.mark.cuda
def test_poly_kernels_refuse_what_they_do_not_take():
    _card()
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa

    A, dinv = _poly_operator("stencil_strips", torch.float64)
    v = torch.randn(A.shape[0], dtype=torch.float64, device="cuda")
    args = (2.0, 1.0, 2.0)
    with pytest.raises(TypeError):  # f32 vector, f64 strips
        pa.cheb_apply(A, 8, *args, v.float())
    with pytest.raises(TypeError):
        pa.neumann_apply(A, dinv.cpu(), 4, 0.8, v)
    with pytest.raises(ValueError):
        pa.cheb_apply(A, pa.MAX_DEGREE + 1, *args, v)
    with pytest.raises(ValueError):
        pa.neumann_apply(A, dinv, 4, 0.8, v[:-1])
    with pytest.raises(ValueError):
        pa.cheb_apply_cuda(A, 8, *args, v.cpu())


# the tiled design of kernels #3 and #4 (csrc/poly_tiled.cu) on heat's
# stencil: every degree here has a tile plan at these sizes
TILED_SIZES = (16, 64, 256, 1024)
TILED_DEGREES = (1, 2, 3, 8, 16)


@pytest.fixture(scope="module")
def heat_on_card():
    """M -> (operator, inverse diagonal, theta, delta) of heat on the card,
    assembled once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from structurepreservingiterativesolvers_torch import precond
    from structurepreservingiterativesolvers_torch.models import heat

    out = {}
    for M in TILED_SIZES:
        A = heat.linforms(M=M, device="cuda").A
        base = precond.chebyshev(A, degree=8)
        out[M] = (A, precond.neumann(A, degree=4).dinv,
                  0.5 * (base.lmax + base.lmin), 0.5 * (base.lmax - base.lmin))
    return out


def _tiled_apply(pa, sys_, kind, degree, dtype, seed=11):
    A, dinv, theta, delta = sys_
    A, dinv = A.astype(dtype), dinv.to(dtype)
    v = torch.randn(A.shape[0], generator=torch.Generator().manual_seed(seed),
                    dtype=dtype).cuda()
    if kind == "cheb":
        args = (A, degree, theta, delta, theta / delta, v)
        return args, pa.cheb_apply, pa.cheb_apply_torch
    args = (A, dinv, degree, 0.8, v)
    return args, pa.neumann_apply, pa.neumann_apply_torch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M", TILED_SIZES)
def test_tiled_poly_kernels_match_plain(heat_on_card, M, dtype):
    """The tiled design against the plain twins at degrees 1, 2, 3, 8 and
    16, launched through the dispatch, which picks it on heat's stencil."""
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa

    for kind in ("cheb", "neumann"):
        tiled = getattr(pa, f"{kind}_apply_tiled_cuda")
        for degree in TILED_DEGREES:
            args, kernel, plain = _tiled_apply(pa, heat_on_card[M], kind,
                                               degree, dtype)
            assert pa.poly_design(args[0], kind, degree, dtype) == "tiled"
            before = tiled.launches
            y = kernel(*args)
            torch.cuda.synchronize()
            assert tiled.launches == before + 1
            ref = plain(*args)
            assert y.dtype == dtype and bool(torch.isfinite(y).all())
            rel = float((y - ref).abs().max() / ref.abs().max())
            assert rel <= POLY_RTOL[dtype], (kind, degree, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_poly_stencil_beyond_the_box_runs_flat(dtype):
    """A stencil with strips whose offsets reach two grid rows has no tile
    plan: the dispatch launches the flat design, against the plain twins on
    a ragged grid at degrees 1, 2, 3 and 8."""
    _card()
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA
    from structurepreservingiterativesolvers_torch.ops.stencil import Stencil

    R, C = 53, 41
    offsets = (-2 * C, -C - 1, -1, 0, 1, C + 1, 2 * C)
    const, offsets, grid_c, st = _stencil_operands(R, C, offsets, False, True,
                                                   dtype)
    const = tuple(0.1 * c + (2.0 if o == 0 else 0.0)
                  for c, o in zip(const, offsets))
    st = tuple(0.1 * s for s in st)
    n = R * C
    dia = DIA(data=torch.zeros(len(offsets), n, dtype=dtype, device="cuda"),
              offsets=offsets, shape=(n, n), wrap=False)
    A = Stencil(dia=dia, const=const, top_vals=st[0], bot_vals=st[1],
                left_vals=st[2], right_vals=st[3], grid_c=grid_c)
    dinv = torch.full((n,), 1.0 / const[offsets.index(0)], dtype=dtype,
                      device="cuda")
    v = torch.randn(n, generator=torch.Generator().manual_seed(2),
                    dtype=dtype).cuda()
    for degree in (1, 2, 3, 8):
        for kind, args, plain in (
                ("cheb", (A, degree, 2.0, 1.0, 2.0, v), pa.cheb_apply_torch),
                ("neumann", (A, dinv, degree, 0.8, v),
                 pa.neumann_apply_torch)):
            assert pa.poly_design(A, kind, degree, dtype) == "flat"
            flat = getattr(pa, f"{kind}_apply_flat_cuda")
            before = flat.launches
            y = getattr(pa, f"{kind}_apply")(*args)
            torch.cuda.synchronize()
            assert flat.launches == before + 1
            ref = plain(*args)
            rel = float((y - ref).abs().max() / ref.abs().max())
            assert rel <= POLY_RTOL[dtype], (kind, degree, rel)


@pytest.mark.cuda
def test_tiled_poly_kernels_repeat_bit_equal(heat_on_card):
    """No atomics and a fixed order of sums: two launches on the same input
    give the same bits, at the size of the main path and a small one."""
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa

    for M in (64, 1024):
        for kind, degree in (("cheb", 8), ("neumann", 4)):
            for dtype in (torch.float64, torch.float32):
                args, kernel, _ = _tiled_apply(pa, heat_on_card[M], kind,
                                               degree, dtype)
                first, second = kernel(*args), kernel(*args)
                torch.cuda.synchronize()
                assert torch.equal(first, second), (M, kind, degree, dtype)


@pytest.mark.cuda
def test_poly_dispatch_by_shape_on_card(heat_on_card):
    """heat's stencil runs the tiled design; swe's DIA, and a degree whose
    halo no tile holds, run the flat one.  Each design counts its own
    launches, and the dispatch counts both."""
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.models import swe

    A_swe = swe.linforms(M=32, device="cuda").A
    dinv_swe = 1.0 / A_swe.data[A_swe.offsets.index(0)]
    v_swe = torch.randn(A_swe.shape[0], dtype=torch.float64, device="cuda")
    A, dinv, theta, delta = heat_on_card[64]
    v = torch.randn(A.shape[0], dtype=torch.float64, device="cuda")
    calls = [
        ("tiled", lambda: pa.cheb_apply(A, 8, theta, delta, theta / delta, v)),
        ("tiled", lambda: pa.neumann_apply(A, dinv, 4, 0.8, v)),
        ("flat", lambda: pa.cheb_apply(A_swe, 8, 2.0, 1.0, 2.0, v_swe)),
        ("flat", lambda: pa.neumann_apply(A_swe, dinv_swe, 4, 0.8, v_swe)),
        ("flat", lambda: pa.cheb_apply(A, pa.MAX_DEGREE, theta, delta,
                                       theta / delta, v)),
    ]
    counters = (pa.cheb_apply_tiled_cuda, pa.neumann_apply_tiled_cuda,
                pa.cheb_apply_flat_cuda, pa.neumann_apply_flat_cuda,
                pa.cheb_apply_cuda, pa.neumann_apply_cuda)
    for design, call in calls:
        before = [c.launches for c in counters]
        call()
        torch.cuda.synchronize()
        grew = [c.launches - b for c, b in zip(counters, before)]
        tiled, flat, total = (grew[0] + grew[1], grew[2] + grew[3],
                              grew[4] + grew[5])
        assert (tiled, flat, total) == ((1, 0, 1) if design == "tiled"
                                        else (0, 1, 1))


@pytest.fixture(scope="module")
def heat_stencils(heat_on_card):
    """M -> heat's stencil on the card in f64, for the tiled stencil
    design: the sizes of ``heat_on_card`` and M=17 (an odd M, which
    assembles as a stencil in f32)."""
    from structurepreservingiterativesolvers_torch.models import heat

    out = {M: sys_[0] for M, sys_ in heat_on_card.items()}
    out[17] = heat.linforms(M=17, device="cuda",
                            dtype=torch.float32).A.astype(torch.float64)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M", (16, 17, 64, 256, 1024))
def test_tiled_stencil_matches_flat_and_plain(heat_stencils, M, dtype):
    """heat's product runs the tiled design through the dispatch: within the
    bound of the plain twin, the flat design's bits, and bit-equal when
    repeated; at M=64 every tile gives the same bits."""
    from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks

    S = heat_stencils[M].astype(dtype)
    x = torch.randn(S.shape[0], generator=torch.Generator().manual_seed(M),
                    dtype=dtype).cuda()
    args = (S.const, S.offsets, S.wrap, S.grid_c, S.strips, x)
    assert ks.stencil_plan(S.shape[0], S.grid_c, S.offsets, S.wrap) is not None
    before = (ks.stencil_spmv_tiled_cuda.launches,
              ks.stencil_spmv_flat_cuda.launches)
    y = S @ x
    rec = S._launch  # resolved on the first product and kept
    again = S @ x
    assert S._launch is rec and rec.design == "tiled"
    flat = ks.stencil_spmv_flat_cuda(*args)
    torch.cuda.synchronize()
    assert (ks.stencil_spmv_tiled_cuda.launches,
            ks.stencil_spmv_flat_cuda.launches) == (before[0] + 2, before[1] + 1)
    ref = stencil_spmv_torch(*args)
    assert float((y - ref).abs().max() / ref.abs().max()) <= RTOL[dtype]
    assert torch.equal(y, flat) and torch.equal(y, again)
    if M == 64:
        for tile in ks.stencil_tiles(S.shape[0], S.grid_c, S.offsets, S.wrap):
            other = ks.stencil_spmv_tiled_cuda(S.const, S.offsets, S.grid_c,
                                               S.strips, tile, x)
            torch.cuda.synchronize()
            assert torch.equal(other, y), tile


@pytest.mark.cuda
def test_stencil_dispatch_by_shape_on_card(heat_stencils):
    """Strips within the box run tiled; no strips, wrap, or offsets beyond
    the box run flat.  Each design counts its own launches, and the
    dispatch counts both."""
    from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks

    S = heat_stencils[64]
    x64 = torch.randn(S.shape[0], dtype=torch.float64, device="cuda")
    calls = [("tiled", S.const, S.offsets, False, S.grid_c, S.strips, x64)]
    for R, C, offsets, wrap, strips in (
            (1, 1000, (-130, -1, 0, 1, 130), True, False),
            (1, 777, (-256, -3, 0, 3, 256), False, False),
            (53, 41, (-2 * 41, -42, -1, 0, 1, 42, 2 * 41), False, True)):
        const, offs, grid_c, st = _stencil_operands(R, C, offsets, wrap,
                                                    strips, torch.float64)
        calls.append(("flat", const, offs, wrap, grid_c, st,
                      torch.randn(R * C, dtype=torch.float64, device="cuda")))
    counters = (ks.stencil_spmv_tiled_cuda, ks.stencil_spmv_flat_cuda,
                ks.stencil_spmv_cuda)
    for design, *args in calls:
        plan = ks.stencil_plan(args[-1].shape[0], args[3], tuple(args[1]),
                               args[2])
        assert (plan is None) == (design == "flat")
        before = [c.launches for c in counters]
        y = stencil_spmv(*args)
        torch.cuda.synchronize()
        grew = [c.launches - b for c, b in zip(counters, before)]
        assert grew == ([1, 0, 1] if design == "tiled" else [0, 1, 1])
        ref = stencil_spmv_torch(*args)
        assert float((y - ref).abs().max() / ref.abs().max()) <= RTOL[torch.float64]


# the fused CGS2 update (kernel #5) against its twin, the pair of products
# w − h @ Q and Q @ w1: the same sums in another order; max|Δ| / max|ref|,
# with a random h so that u2 does not cancel
ORTHO_RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 21, 61, 128])
@pytest.mark.parametrize("n", [33, 1000, 70000])
def test_ortho_kernel_matches_plain(dtype, m, n):
    _card()
    from structurepreservingiterativesolvers_torch.kernels import ortho

    g = torch.Generator().manual_seed(m * n)
    Q, w, h = (torch.randn(*shape, generator=g, dtype=dtype).cuda()
               for shape in ((m, n), (n,), (m,)))
    before = ortho.fused_update_matvec_cuda.launches
    w1, u2 = ortho.fused_update_matvec(Q, w, h)
    w1b, u2b = ortho.fused_update_matvec(Q, w, h)
    torch.cuda.synchronize()
    assert ortho.fused_update_matvec_cuda.launches == before + 2
    assert torch.equal(w1, w1b) and torch.equal(u2, u2b)  # no atomics
    ref_w1, ref_u2 = ortho.fused_update_matvec_torch(Q, w, h)
    for got, ref in ((w1, ref_w1), (u2, ref_u2)):
        assert got.dtype == dtype and got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) <= ORTHO_RTOL[dtype]


@pytest.mark.cuda
def test_ortho_kernel_refuses_what_it_does_not_take():
    _card()
    from structurepreservingiterativesolvers_torch.kernels import ortho

    Q = torch.randn(4, 100, dtype=torch.float64, device="cuda")
    w = torch.randn(100, dtype=torch.float64, device="cuda")
    h = torch.randn(4, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError):
        ortho.fused_update_matvec(torch.zeros(ortho.MAX_ROWS + 1, 100,
                                              dtype=torch.float64, device="cuda"),
                                  w, torch.zeros(ortho.MAX_ROWS + 1,
                                                 dtype=torch.float64,
                                                 device="cuda"))
    with pytest.raises(TypeError):
        ortho.fused_update_matvec(Q, w.float(), h)
    with pytest.raises(ValueError):
        ortho.fused_update_matvec(Q.T.contiguous().T, w, h)
    with pytest.raises(ValueError):
        ortho.fused_update_matvec(Q, w, h.cpu())
    with pytest.raises(ValueError):
        ortho.fused_update_matvec_cuda(Q.cpu(), w.cpu(), h.cpu())


@pytest.mark.cuda
def test_swe_fused_ortho_and_snc_on_card_match_cpu():
    """swe M=32 with the skew-normal Chebyshev and the fused
    orthogonalisation: the same degree, bounds, steps and safety on the card
    as on the CPU, kernel #5 once per Arnoldi step and kernel #1 in every
    product, and the same iterate to 1e-8."""
    _card()
    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.kernels import ortho
    from structurepreservingiterativesolvers_torch.models import swe

    out = {}
    for device in ("cpu", "cuda"):
        s = swe.linforms(M=32, device=device)
        pre = default_pre_builder("swe")(s)
        before = (dia_spmv_cuda.launches, ortho.fused_update_matvec_cuda.launches)
        x, info = wrappers.cgmres_wrapper(s, k=20, tol=1e-7, pre=pre,
                                          ortho="cgs2_fused")
        torch.cuda.synchronize()
        out[device] = (pre, x.cpu(), info,
                       dia_spmv_cuda.launches - before[0],
                       ortho.fused_update_matvec_cuda.launches - before[1])
    (pc, xc, ic, dc, oc), (pg, xg, ig, dg, og) = out["cpu"], out["cuda"]
    assert dc == oc == 0 and dg > 0 and og == ig["steps"]
    assert pg.degree == pc.degree
    for key in ("lmin", "lmax"):
        assert abs(getattr(pg, key) - getattr(pc, key)) <= 1e-10 * getattr(pc, key)
    for key in ("steps", "constrained_steps", "safety"):
        assert ig[key] == ic[key]
    assert ig["safety"] is True and ig["deviation"] <= 1e-10
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_fused"])
def test_graph_core_on_card(ortho):
    """The device core on the card: each step a CUDA graph.  Its replays
    give the bits of the same steps run eagerly on the card, the host loop's
    iterate to 1e-10, and count the kernels they launch: a solve's DIA and
    fused CGS2 launches equal the eager core's."""
    _card()
    import importlib

    from structurepreservingiterativesolvers_torch.kernels.ortho import (
        fused_update_matvec_cuda,
    )
    from structurepreservingiterativesolvers_torch.models import swe
    from structurepreservingiterativesolvers_torch.solvers.graphs import (
        GraphRunner,
    )

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    s = swe.linforms(M=32, device="cuda")
    kw = dict(k=60, tol=1e-9, constraints=s.constraints(), ortho=ortho)
    xh, ih = cg.cgmres(s.A, s.b, **kw)
    xg, ig = cg.cgmres(s.A, s.b, loop="while", timing=True, **kw)
    assert ig["timings"]["time_capture"] > 0

    def counts():
        return dia_spmv_cuda.launches, fused_update_matvec_cuda.launches

    before = counts()
    x2, i2 = cg.cgmres(s.A, s.b, loop="while", timing=True, **kw)
    torch.cuda.synchronize()
    replayed = [a - b for a, b in zip(counts(), before)]
    assert i2["timings"]["time_capture"] == 0  # nothing captured again
    core = cg.DeviceCore(s.A, None, 60, s.constraints(), like=s.b, tol=1e-9,
                         ortho=ortho, x0_zero=True,
                         runner=GraphRunner("cuda", capture=False))
    before = counts()
    core.load(s.b, None, s.constraints())
    core.solve()
    torch.cuda.synchronize()
    eager = [a - b for a, b in zip(counts(), before)]
    assert replayed == eager and replayed[0] > 0
    assert (replayed[1] > 0) == (ortho == "cgs2_fused")
    xe = core.result().x
    assert float((xg - xe).abs().max() / xe.abs().max()) <= 1e-13
    assert torch.equal(xg, x2)
    for key in ("steps", "constrained_steps", "safety"):
        assert ig[key] == ih[key]
    assert float((xg - xh).abs().max() / xh.abs().max()) <= 1e-10
    cg.clear_core_cache()


@pytest.mark.cuda
def test_fused_evolve_on_card_matches_cpu():
    """``fused_evolve`` replays its graphs every step on the card and gives
    the CPU's evolution: steps per step within one, every latch certified,
    the drifts at roundoff; the DIA launches it counts are its replays'
    (the warm-ups' are not counted)."""
    _card()
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )

    kw = dict(N=4, M=16, k=20, tol=1e-7, T=1.0, warm_start=False)
    cpu = fused_evolve("swe", device="cpu", **kw)
    before = dia_spmv_cuda.launches
    gpu = fused_evolve("swe", device="cuda", **kw)
    made = dia_spmv_cuda.launches - before
    assert made == gpu["timings"]["launches"]["dia_spmv"] > 0
    assert all(abs(int(a) - int(b)) <= 1 for a, b in zip(gpu["steps"], cpu["steps"]))
    assert all(int(sf) == 1 for sf in gpu["safety"])
    assert max(gpu["dm"]) < 1e-9 and max(gpu["de"]) / 3e4 < 1e-13
    assert gpu["timings"]["step_capture"][1:].sum() == 0  # captured once
    assert gpu["sol"].device.type == "cuda"


# the batched kernel's edge cases beside CASES: odd offsets, odd n, wraps
# and zero fills that cross 0 and n inside a block, a ragged last block
SPMM_CASES = CASES + [
    (1001, (-287, -255, -1, 0, 1, 255, 287), True),
    (1001, (-287, -255, -1, 0, 1, 255, 287), False),
    (4097, (-2049, -3, 0, 5, 1023), False),
    # swe M=16's shape: three strips of 256 rows (spmm_strip)
    (768, (-287, -272, -256, -255, -16, 0, 16, 255, 256, 272, 287), True),
    (768, (-287, -272, -256, -255, -16, 0, 16, 255, 256, 272, 287), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,offsets,wrap", SPMM_CASES)
def test_spmm_kernel_matches_plain(dtype, n, offsets, wrap):
    """The batched DIA kernel in both designs (tile, spread),
    each counting in its own counter, on the (n, B) view of a (B, n) block, on a
    contiguous (n, B) block and on rows at an odd stride, against its plain
    twin, for widths within a tile, at a tile and past one; every design
    gives ``A @ X``'s bits, a second launch too, and each column is kernel
    #1's product of it bit for bit."""
    _card()
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA

    g = torch.Generator().manual_seed(n)
    data = torch.randn(len(offsets), n, generator=g, dtype=dtype).cuda()
    data[:, : n // 3] = 0.0  # dead segments, which the live design skips
    A = DIA(data, offsets, (n, n), wrap)
    for B in (1, 3, 8, 9, 41):
        X = torch.randn(B, n, generator=g, dtype=dtype).cuda().T
        odd = torch.randn(B, n + 1, generator=g, dtype=dtype).cuda()[:, 1:].T
        odd.copy_(X)  # rows at the odd stride n + 1, one element in
        ref = kd.dia_spmm_torch(data, offsets, wrap, X)
        Y = A @ X
        cols = torch.stack([A @ X[:, b].contiguous() for b in range(B)], 1)
        outs = [A @ X.contiguous(), A @ odd, A @ X]
        for design in kd.DESIGNS:
            counter = getattr(kd, f"dia_spmm_{design}_cuda")
            before = counter.launches
            outs.append(counter(data, offsets, wrap, X, A.live()))
            outs.append(counter(data, offsets, wrap, odd))
            assert counter.launches == before + 2
        torch.cuda.synchronize()
        err = float((Y - ref).abs().max() / ref.abs().max())
        assert err <= RTOL[dtype], (B, err)
        assert Y.shape == (n, B) and torch.equal(Y, cols)
        for i, out in enumerate(outs):
            assert torch.equal(out, Y), (B, i)


@pytest.mark.cuda
def test_spmm_kernel_refuses_what_it_does_not_take():
    _card()
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.ops import sparse as tsp

    data = torch.randn(3, 64, dtype=torch.float64, device="cuda")
    X = torch.randn(64, 4, dtype=torch.float64, device="cuda")
    before = kd.dia_spmm_cuda.launches
    for plan in (kd.SpmmPlan("tile", 5, 4, 1, 64),  # a tile not built
                 kd.SpmmPlan("spread", 1, 1, 3, 64),  # a depth not built
                 kd.SpmmPlan("tile", 4, 4, 2, 64),  # a (tile, depth) not built
                 # a strip that cuts a warp's rows
                 kd.SpmmPlan("tile", 4, 4, 1, 48)):
        with pytest.raises(RuntimeError):
            kd.dia_spmm_cuda(data, (-1, 0, 1), True, X, plan=plan)
    for design in ("tiled", "pair", "staged"):
        with pytest.raises(ValueError):
            kd.dia_spmm_cuda(data, (-1, 0, 1), True, X,
                             plan=kd.SpmmPlan(design, 4, 4, 1, 64))
    assert kd.dia_spmm_cuda.launches == before
    with pytest.raises(TypeError):
        kd.dia_spmm_cuda(data, (-1, 0, 1), True, X.float())
    with pytest.raises(ValueError):
        kd.dia_spmm_cuda(data, (-1, 0, 1), True, X.cpu())
    # the product the port calls launches the kernel or raises: no plain
    # fallback on a CUDA block the kernel does not take
    with pytest.raises(TypeError):
        tsp.dia_spmm(tsp.DIA(data, (-1, 0, 1), (64, 64), True), X.float())


@pytest.mark.cuda
def test_spmm_plan_runs_its_design_on_card():
    """``A @ X`` launches the design ``spmm_plan`` picks and counts it
    there: tile on a large operator, spread on a small one."""
    _card()
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA

    for n, want in ((200_000, "tile"), (9_600, "spread")):
        data = torch.randn(3, n, dtype=torch.float64, device="cuda")
        A = DIA(data, (-1, 0, 1), (n, n), True)
        X = torch.randn(8, n, dtype=torch.float64, device="cuda").T
        plan = kd.spmm_plan(n, 8, torch.float64)
        counts = {d: getattr(kd, f"dia_spmm_{d}_cuda").launches
                  for d in kd.DESIGNS}
        A @ X
        torch.cuda.synchronize()
        assert plan.design == want
        for d in kd.DESIGNS:
            assert (getattr(kd, f"dia_spmm_{d}_cuda").launches - counts[d]
                    == (d == want))


@pytest.mark.cuda
def test_cgmres_many_on_card_matches_cpu():
    """A swe batch with the skew-normal Chebyshev whose items stop at
    different steps: the same steps and latches on the card as on the CPU,
    x within 1e-10, and every product with the batch through the batched
    kernel (none through kernel #1)."""
    _card()
    import importlib

    import torch_parity
    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.models import swe

    ref = torch_parity.reference_script()
    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    out = {}
    for device in ("cpu", "cuda"):
        s = swe.linforms(M=32, device=device)
        pre = default_pre_builder("swe")(s)
        states = torch.as_tensor(ref.batch_states("swe_M32_snc_B4",
                                                  s.z0.cpu().numpy()),
                                 device=device)
        items = [s.step_update(z) for z in states]
        before = kd.dia_spmm_cuda.launches, kd.dia_spmv_cuda.launches
        X, info = cgmres_many(s.A, torch.stack([t.b for t in items]),
                              [t.constraints() for t in items], k=20,
                              tol=1e-7, pre=pre)
        out[device] = (X.cpu(), info, kd.dia_spmm_cuda.launches - before[0],
                       kd.dia_spmv_cuda.launches - before[1])
    (xc, ic, _, _), (xg, ig, spmm, spmv) = out["cpu"], out["cuda"]
    assert list(ig["steps"]) == list(ic["steps"]) == [4, 5, 5, 5]
    assert list(ig["safety"]) == list(ic["safety"]) == [1, 1, 1, 1]
    assert float((xg - xc).abs().max() / xc.abs().max()) <= 1e-10
    assert spmm > 0 and spmv == 0
    cg.clear_core_cache()
