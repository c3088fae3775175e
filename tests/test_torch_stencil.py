"""The Stencil operator and the plain twin of the stencil kernel of the
PyTorch port against the JAX package.

``maybe_stencil`` is copied exactly, so on the same DIA both packages give
the same constants, grid row length and strip arrays, bit for bit, and both
decline the same operators.  On the CPU the port's ``stencil_spmv`` is the
kernel's plain twin: held against the JAX XLA path in f64 (1e-14 relative
to max|y|: the same products, summed in the same order) and against the
Pallas TPU kernel, in interpret mode, plus the JAX strip pass in f32 (1e-6:
the Pallas kernel sums in its own order).  The CUDA kernel itself is
checked against the plain twin on the card, in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import interop
from structurepreservingiterativesolvers_torch.kernels.stencil_spmv import (
    stencil_spmv,
    stencil_spmv_cuda,
    stencil_spmv_torch,
)
from structurepreservingiterativesolvers_torch.ops import sparse as tsp
from structurepreservingiterativesolvers_torch.ops import stencil as tst
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.ops import sparse as jsp
from structurepreservingiterativesolvers_tpu.ops import stencil as jst

RTOL64, RTOL32 = 1e-14, 1e-6


def _periodic_laplacian(n):
    """An exactly constant, wrapping operator: a Stencil without strips."""
    data = np.stack([np.full(n, -1.0), np.full(n, 2.5), np.full(n, -1.0)])
    return jsp.DIA(jnp.asarray(data), (-1, 0, 1), (n, n), True)


def _wrapped_with_residual(n=300):
    """A wrapping DIA whose rows differ: no strips on a periodic grid."""
    rng = np.random.default_rng(5)
    return jsp.DIA(jnp.asarray(rng.standard_normal((3, n))), (-7, 0, 7),
                   (n, n), True)


@pytest.fixture(scope="module")
def operators():
    """JAX DIA operators by name."""
    ops = {f"heat{M}": jheat.linforms(M=M).A.dia for M in (16, 64)}
    ops["heat33"] = jheat.linforms(M=33).A  # odd M in f64: a plain DIA
    ops["lkdv"] = jlkdv.linforms(**torch_parity.LKDV_EASY).A
    ops["periodic"] = _periodic_laplacian(1000)
    ops["wrapped"] = _wrapped_with_residual()
    return ops


def _port(Aj, dtype=torch.float64):
    data, offsets, wrap = torch_parity.dia_triple(Aj)
    return interop.dia(data, offsets, wrap, device="cpu", dtype=dtype)


@pytest.mark.parametrize("name", ["heat16", "heat64", "periodic"])
def test_maybe_stencil_matches_jax(operators, name):
    Aj = operators[name]
    Sj, St = jst.maybe_stencil(Aj), tst.maybe_stencil(_port(Aj))
    assert isinstance(Sj, jst.Stencil) and isinstance(St, tst.Stencil)
    assert St.grid_c == Sj.grid_c and St.offsets == Sj.offsets
    assert St.wrap == Sj.wrap and St.shape == tuple(Sj.shape)
    np.testing.assert_array_equal(np.asarray(St.const), np.asarray(Sj.const))
    for field in ("top_vals", "bot_vals", "left_vals", "right_vals"):
        if Sj.grid_c:
            np.testing.assert_array_equal(getattr(St, field).numpy(),
                                          np.asarray(getattr(Sj, field)))
        else:
            assert getattr(St, field) is None and getattr(Sj, field) is None
    if name == "heat64":
        assert St.grid_c == 65 and len(St.offsets) == 7


@pytest.mark.parametrize("name", ["heat33", "lkdv", "wrapped"])
def test_maybe_stencil_declines_as_jax_does(operators, name):
    Aj = operators[name]
    assert isinstance(jst.maybe_stencil(Aj), jsp.DIA)
    At = _port(Aj)
    assert tst.maybe_stencil(At) is At
    assert tst.maybe_stencil("not a DIA") == "not a DIA"


@pytest.mark.parametrize("name", ["heat16", "heat64", "periodic"])
def test_plain_stencil_matches_jax_f64(operators, name):
    Aj = operators[name]
    Sj, St = jst.maybe_stencil(Aj), tst.maybe_stencil(_port(Aj))
    x = np.random.default_rng(1).standard_normal(Aj.shape[0])
    yj = np.asarray(jst.stencil_spmv(Sj, jnp.asarray(x)))
    yt = (St @ torch.as_tensor(x)).numpy()
    assert torch_parity.rel_max(yt, yj) <= RTOL64
    # and the decomposition is the operator: against the explicit DIA
    yd = (St.dia @ torch.as_tensor(x)).numpy()
    assert torch_parity.rel_max(yt, yd) <= RTOL64


@pytest.mark.parametrize("name", ["heat16", "periodic"])
def test_plain_stencil_matches_pallas_f32(operators, name):
    import dataclasses

    Aj = operators[name]
    Sj = dataclasses.replace(jst.maybe_stencil(Aj).astype(jnp.float32),
                             engine="pallas")
    St = tst.maybe_stencil(_port(Aj, torch.float32))
    x = np.random.default_rng(2).standard_normal(Aj.shape[0]).astype(np.float32)
    yp = np.asarray(jst.stencil_spmv(Sj, jnp.asarray(x)))  # interpret mode
    yt = (St @ torch.as_tensor(x)).numpy()
    assert yt.dtype == np.float32
    assert torch_parity.rel_max(yt, yp) <= RTOL32


def test_stencil_surface(operators):
    """The DIA surface: todense goes through the explicit operator; the
    product with a block (n, B) is the stencil product on each column (the
    block form's plain twin), within rounding of the explicit operator's
    SpMM."""
    St = tst.maybe_stencil(_port(operators["heat16"]))
    assert tst.as_dia(St) is St.dia and tst.as_dia(St.dia) is St.dia
    assert St.dtype == torch.float64 and St.device == torch.device("cpu")
    torch.testing.assert_close(St.data, St.dia.data, rtol=0, atol=0)
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((289, 3)))
    Y = St @ X
    for b in range(3):
        torch.testing.assert_close(Y[:, b], St @ X[:, b].contiguous(), rtol=0,
                                   atol=0)
    assert torch_parity.rel_max(Y.numpy(),
                                tsp.dia_spmm(St.dia, X).numpy()) <= RTOL64
    torch.testing.assert_close(St.todense(), St.dia.todense(), rtol=0, atol=0)


def test_wrapper_dispatch_on_cpu(operators):
    """A CPU tensor takes the plain twin and launches nothing; a device the
    port has no kernel for raises; the launcher refuses CPU tensors."""
    St = tst.maybe_stencil(_port(operators["heat16"]))
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(289))
    args = (St.const, St.offsets, St.wrap, St.grid_c, St.strips)
    before = stencil_spmv_cuda.launches
    y = stencil_spmv(*args, x)
    torch.testing.assert_close(y, stencil_spmv_torch(*args, x), rtol=0, atol=0)
    assert stencil_spmv_cuda.launches == before
    with pytest.raises(ValueError):
        stencil_spmv(*args, x.to("meta"))
    with pytest.raises(ValueError):
        stencil_spmv_cuda(*args, x)
