"""DIA SpMV and scipy conversion of the PyTorch port against the JAX package.

On the CPU the port's ``dia_spmv`` is the kernel's plain twin; it is held
against the JAX roll chain in f64 and against the Pallas TPU kernel (in
interpret mode, as ``tests/test_pallas_spmv.py`` runs it) in f32.  The
CUDA kernel itself is checked against the plain twin on the card, in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_parity  # noqa: F401  (sets the thread count)
from structurepreservingiterativesolvers_torch.kernels.dia_spmv import dia_spmv as port_kernel_spmv
from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
    dia_spmv_cuda,
    dia_spmv_torch,
)
from structurepreservingiterativesolvers_torch.ops import sparse as tsp
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.models import swe as jswe
from structurepreservingiterativesolvers_tpu.ops import sparse as jsp
from structurepreservingiterativesolvers_tpu.ops.pallas_spmv import dia_spmv_pallas

# f64: the same multiply-adds in the same diagonal order; the bound leaves
# room for contraction into fused multiply-adds.  f32: the Pallas kernel
# sums in its own order.
RTOL64, RTOL32 = 1e-14, 1e-6


def _random_csr(n, offsets, wrap, seed):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(n)
        j = i + off
        keep = np.ones(n, bool) if wrap else (j >= 0) & (j < n)
        rows.append(i[keep])
        cols.append(j[keep] % n)
        vals.append(rng.standard_normal(int(keep.sum())))
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()


# shared with tests/test_torch_cuda.py
RANDOM_CASES = [
    # n, offsets, wrap: no wrap with ragged n, a span wider than 128 lanes
    # (wrapped and not), and a periodic operator with both signs of offset
    (1000, (-3, -1, 0, 1, 3), False),
    (1024, (-130, -1, 0, 1, 130), True),
    (777, (-256, 0, 256), False),
    (300, (-7, 0, 7), True),
]


@pytest.fixture(scope="module")
def operators():
    ops = {}
    for n, offs, wrap in RANDOM_CASES:
        A = _random_csr(n, offs, wrap, seed=n)
        ops[f"random_{n}"] = jsp.dia_from_scipy(A, wrap=wrap)
    e = jlkdv.linforms(**torch_parity.LKDV_EASY)
    ops.update(lkdv_A=e.A, lkdv_M=e.Mmat, lkdv_G=e.Gmat,
               swe16_A=jswe.linforms(M=16).A)
    return ops


def _port(Aj, dtype=torch.float64):
    data, offsets, wrap = torch_parity.dia_triple(Aj)
    return tsp.DIA(torch.tensor(data, dtype=dtype), offsets,
                   tuple(Aj.shape), wrap)


OPERATOR_NAMES = [f"random_{c[0]}" for c in RANDOM_CASES] + [
    "lkdv_A", "lkdv_M", "lkdv_G", "swe16_A"]


@pytest.mark.parametrize("name", OPERATOR_NAMES)
def test_dia_spmv_matches_jax_f64(operators, name):
    Aj = operators[name]
    x = np.random.default_rng(1).standard_normal(Aj.shape[0])
    yj = np.asarray(jax.jit(jsp.dia_spmv)(Aj, jnp.asarray(x)))
    yt = (_port(Aj) @ torch.as_tensor(x)).numpy()
    assert torch_parity.rel_max(yt, yj) <= RTOL64


@pytest.mark.parametrize("name", ["random_777", "swe16_A"])
def test_dia_spmv_matches_pallas_f32(operators, name):
    Aj = operators[name].astype(jnp.float32)
    x = np.random.default_rng(2).standard_normal(Aj.shape[0]).astype(np.float32)
    yp = np.asarray(dia_spmv_pallas(Aj, jnp.asarray(x), block_rows=512,
                                    interpret=True))
    yt = (_port(Aj, torch.float32) @ torch.as_tensor(x)).numpy()
    assert torch_parity.rel_max(yt, yp) <= RTOL32


def test_dia_spmm_matches_jax(operators):
    Aj = operators["lkdv_G"]
    X = np.random.default_rng(3).standard_normal((Aj.shape[0], 4))
    Yj = np.asarray(jsp.dia_spmm(Aj, jnp.asarray(X)))
    Yt = (_port(Aj) @ torch.as_tensor(X)).numpy()
    assert torch_parity.rel_max(Yt, Yj) <= RTOL64


@pytest.mark.parametrize("wrap", [None, True, False])
def test_dia_from_scipy_matches_jax(wrap):
    A = _random_csr(1024, (-130, -1, 0, 1, 130), True, seed=5)
    Aj = jsp.dia_from_scipy(A, wrap=wrap)
    At = tsp.dia_from_scipy(A, wrap=wrap, device="cpu")
    assert At.offsets == Aj.offsets and At.wrap == Aj.wrap
    assert At.shape == tuple(Aj.shape)
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))


def test_from_scipy_matches_jax_on_models():
    e = jlkdv.linforms(**torch_parity.LKDV_EASY)
    for csr in (e.A_csr, jswe.linforms(M=16).A_csr):
        Aj, At = jsp.from_scipy(csr), tsp.from_scipy(csr, device="cpu")
        assert isinstance(Aj, jsp.DIA)
        assert At.offsets == Aj.offsets and At.wrap == Aj.wrap
        np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))
        # and back: to_scipy reproduces the matrix
        assert abs(tsp.to_scipy(At) - csr).max() == 0.0


def test_from_scipy_refuses_ell():
    """Where the JAX package picks ELL, the port picks ELL too, with the
    same slots."""
    A = sp.random(200, 200, density=0.05, random_state=0, format="csr")
    Aj, At = jsp.from_scipy(A), tsp.from_scipy(A, device="cpu")
    assert isinstance(Aj, jsp.ELL) and isinstance(At, tsp.ELL)
    np.testing.assert_array_equal(At.cols.numpy(), np.asarray(Aj.cols))
    np.testing.assert_array_equal(At.vals.numpy(), np.asarray(Aj.vals))


def test_wrapper_dispatch_on_cpu():
    """A CPU tensor takes the plain twin and launches nothing; a device the
    port has no kernel for raises; the launcher refuses CPU tensors."""
    data = torch.randn(3, 50, dtype=torch.float64)
    x = torch.randn(50, dtype=torch.float64)
    before = dia_spmv_cuda.launches
    y = port_kernel_spmv(data, (-1, 0, 1), True, x)
    torch.testing.assert_close(y, dia_spmv_torch(data, (-1, 0, 1), True, x),
                               rtol=0, atol=0)
    assert dia_spmv_cuda.launches == before
    with pytest.raises(ValueError):
        port_kernel_spmv(data.to("meta"), (-1, 0, 1), True, x.to("meta"))
    with pytest.raises(ValueError):
        dia_spmv_cuda(data, (-1, 0, 1), True, x)
