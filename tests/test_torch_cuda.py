"""Tests of the PyTorch port that need an NVIDIA card: the CUDA DIA and
stencil kernels, the fused Chebyshev and Neumann applies and the fused CGS2
update against their plain twins, and solves on the card (lkdv, heat with
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
