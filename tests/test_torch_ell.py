"""The ELL and BSR formats of the port against the JAX package's and scipy,
on the lkdvRK stage system at M=50, degree 4, 3 stages (the JAX package
stores its A as ELL, width 48) and its block mass inverse (a BSR of 5 × 5
blocks), in f64 on the CPU; and the differentiable DIA product that the
general constraints take their derivatives through."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.ops import sparse as tsp
from structurepreservingiterativesolvers_tpu.models import lkdvrk as jlkdvrk
from structurepreservingiterativesolvers_tpu.ops import sparse as jsp

RTOL = 1e-13


@pytest.fixture(scope="module")
def stage():
    """The JAX system at M=50, degree 4, 3 stages, and seeded inputs."""
    js = jlkdvrk.linforms(N=10, M=50, degree=4, tstages=3)
    rng = np.random.default_rng(7)
    n = js.b.shape[0]
    return js, rng.standard_normal(n), rng.standard_normal((n, 5))


def test_from_scipy_picks_ell_as_jax(stage):
    js = stage[0]
    At = tsp.from_scipy(js.A_csr, device="cpu")
    assert isinstance(js.A, jsp.ELL) and isinstance(At, tsp.ELL)
    assert At.row_width == js.A.row_width == 48
    assert At.shape == tuple(js.A.shape)
    np.testing.assert_array_equal(At.cols.numpy(), np.asarray(js.A.cols))
    np.testing.assert_array_equal(At.vals.numpy(), np.asarray(js.A.vals))
    assert abs(tsp.to_scipy(At) - js.A_csr).max() == 0.0


def test_ell_products_match_jax_and_scipy(stage):
    js, x, X = stage
    At = tsp.ell_from_scipy(js.A_csr, device="cpu")
    y = (At @ torch.as_tensor(x)).numpy()
    torch_parity.close(y, np.asarray(jsp.ell_spmv(js.A, jnp.asarray(x))), RTOL)
    torch_parity.close(y, js.A_csr @ x, RTOL)
    Y = (At @ torch.as_tensor(X)).numpy()
    torch_parity.close(Y, np.asarray(jsp.ell_spmm(js.A, jnp.asarray(X))), RTOL)
    torch_parity.close(Y, js.A_csr @ X, RTOL)


def test_bsr_matches_jax_and_scipy(stage):
    js, x, X = stage
    Mi = sp.csr_matrix(np.asarray(js.Minv.todense()))
    Bt = tsp.bsr_from_scipy(Mi, js.prob.degree + 1, device="cpu")
    assert Bt.block_size == js.Minv.block_size == 5
    assert tuple(Bt.block_rows.tolist()) == js.Minv.block_rows
    assert tuple(Bt.block_cols.tolist()) == js.Minv.block_cols
    np.testing.assert_array_equal(Bt.blocks.numpy(), np.asarray(js.Minv.blocks))
    np.testing.assert_array_equal(Bt.todense().numpy(), Mi.toarray())
    n0 = js.n0
    y = (Bt @ torch.as_tensor(x[:n0])).numpy()
    torch_parity.close(y, np.asarray(jsp.bsr_spmv(js.Minv, jnp.asarray(x[:n0]))),
                       RTOL)
    torch_parity.close(y, Mi @ x[:n0], RTOL)
    Y = (Bt @ torch.as_tensor(X[:n0])).numpy()
    torch_parity.close(Y, np.asarray(jsp.bsr_spmm(js.Minv, jnp.asarray(X[:n0]))),
                       RTOL)
    torch_parity.close(Y, Mi @ X[:n0], RTOL)


def test_spmv_and_spmm_dispatch_every_format(stage):
    js, x, X = stage
    n0 = js.n0
    csr = sp.csr_matrix(js.Mh)
    ops = [tsp.dia_from_scipy(csr, device="cpu"),
           tsp.ell_from_scipy(csr, device="cpu"),
           tsp.bsr_from_scipy(csr, js.prob.degree + 1, device="cpu"),
           torch.as_tensor(csr.toarray())]
    for A in ops:
        torch_parity.close(tsp.spmv(A, torch.as_tensor(x[:n0])).numpy(),
                           csr @ x[:n0], RTOL)
        torch_parity.close(tsp.spmm(A, torch.as_tensor(X[:n0])).numpy(),
                           csr @ X[:n0], RTOL)


@pytest.mark.parametrize("wrap", [True, False])
def test_dia_product_differentiates(wrap, monkeypatch):
    """``A @ x`` under ``torch.func``: the transpose, grad and hessian of a
    quadratic through a DIA equal the dense ones; plain autograd too.  The
    SpMV wrapper always receives tensors with storage, whose addresses the
    kernel takes on the card."""
    wrapper = tsp.dia_spmv

    def storage_checked(A, x):
        A.data.data_ptr(), x.data_ptr()  # raise for a transform's wrapper
        return wrapper(A, x)

    monkeypatch.setattr(tsp, "dia_spmv", storage_checked)
    n = 40
    rng = np.random.default_rng(11)
    A = sp.diags([rng.standard_normal(n) for _ in range(4)], [-3, -1, 0, 2],
                 shape=(n, n), format="csr")
    if wrap:
        A = A + sp.csr_matrix(([1.5, 2.5], ([0, n - 1], [n - 1, 0])),
                              shape=(n, n))
    D = tsp.dia_from_scipy(A, device="cpu")
    assert D.wrap == wrap
    Ad = torch.as_tensor(A.toarray())

    def f(A, x):
        return 0.5 * torch.dot(x, A @ x) + torch.dot(x, A @ (A @ x))

    x = torch.as_tensor(rng.standard_normal(n))
    for fun in (torch.func.hessian, torch.func.grad):
        torch.testing.assert_close(fun(lambda v: f(D, v))(x),
                                   fun(lambda v: f(Ad, v))(x),
                                   rtol=1e-13, atol=1e-13)
    xr = x.clone().requires_grad_()
    f(D, xr).backward()
    torch.testing.assert_close(xr.grad, torch.func.grad(lambda v: f(Ad, v))(x),
                               rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(D.transpose().todense(), Ad.T, rtol=0, atol=0)
