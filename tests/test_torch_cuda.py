"""Tests of the PyTorch port that need an NVIDIA card: the CUDA DIA kernel
against its plain twin, and a CGMRES solve on the card against the same
solve on the CPU.  They skip where no card is present.

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
