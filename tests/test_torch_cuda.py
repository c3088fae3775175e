"""Tests of the PyTorch port that need an NVIDIA card: the CUDA DIA and
stencil kernels against their plain twins, and CGMRES solves on the card
(lkdv, and heat with the structured AMG) against the same solves on the
CPU.  They skip where no card is present.

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
