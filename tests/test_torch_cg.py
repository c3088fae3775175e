"""Conjugate gradients of the PyTorch port against scipy's direct solve and
the JAX package's CG, on the CPU in f64."""

import numpy as np
import scipy.sparse.linalg as spla

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch.solvers import cg
from structurepreservingiterativesolvers_tpu import precond as jprecond
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.solvers import cg as jcg


def test_cg_on_heat():
    """CG with Jacobi on heat M=32 against scipy's direct solve (as
    tests/test_experiments.py::test_cg_on_heat) and the JAX package's CG."""
    js = jheat.linforms(M=32)
    ts = torch_parity.to_port(js)
    x, info = cg(ts.A, ts.b, k=200, tol=1e-10, pre=tprecond.jacobi(ts.A))
    x_dir = spla.spsolve(ts.A_csr, ts.b.numpy())
    np.testing.assert_allclose(x.numpy(), x_dir, rtol=1e-6, atol=1e-9)
    xj, ij = jcg(js.A, js.b, k=200, tol=1e-10, pre=jprecond.jacobi(js.A))
    assert info["name"] == "cg" and info["steps"] == ij["steps"] < 200
    torch_parity.close(x.numpy(), np.asarray(xj), 1e-10)
    np.testing.assert_allclose(info["res"], np.asarray(ij["res"]), rtol=1e-6)
