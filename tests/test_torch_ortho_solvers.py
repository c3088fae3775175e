"""CGS2 with the fused middle pair (kernel #5's plain twin on the CPU)
against the JAX package: ``_cgs2`` fused and plain against the JAX plain
form, and the solvers with ``ortho="cgs2_fused"`` against ``"cgs2"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch import solvers as tsol
from structurepreservingiterativesolvers_torch.solvers import arnoldi as tarnoldi
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.models import swe as jswe
from structurepreservingiterativesolvers_tpu.solvers import arnoldi as jarnoldi


def _basis(k, n, j, seed=1):
    """An orthonormal Krylov-like basis: rows 0..j orthonormal, the rest
    zero (as in the JAX package's fixed-shape workspace)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
    Q = np.zeros((k + 1, n))
    Q[: j + 1] = q.T
    return Q, rng.standard_normal(n)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("j", [0, 7])
def test_cgs2_matches_jax(fused, j):
    Q, w = _basis(10, 3000, j)
    w2_j, h_j = jarnoldi._cgs2(jnp.asarray(Q), jnp.asarray(w), j, fused="xla")
    w2_t, h_t = tarnoldi._cgs2(torch.from_numpy(Q), torch.from_numpy(w), j,
                               fused=fused)
    torch_parity.close(w2_t.numpy(), np.asarray(w2_j), 1e-12)
    torch_parity.close(h_t.numpy(), np.asarray(h_j)[: j + 1], 1e-12)


def _swe16():
    return torch_parity.to_port(jswe.linforms(M=16)), None, 60, 1e-9


def _heat16():
    s = torch_parity.to_port(jheat.linforms(M=16))
    return s, tprecond.chebyshev(s.A, degree=8), 25, 1e-8


@pytest.mark.parametrize("solver", ["gmres", "cgmres"])
@pytest.mark.parametrize("problem", [_swe16, _heat16], ids=["swe16", "heat16"])
def test_solvers_fused_ortho_match_plain(problem, solver):
    """``ortho="cgs2_fused"`` (and the JAX spelling ``"cgs2_xla"`` of the
    plain form) take the steps of ``"cgs2"`` and give its iterate."""
    s, pre, k, tol = problem()
    kw = dict(k=k, tol=tol, pre=pre)
    if solver == "cgmres":
        kw["constraints"] = s.constraints()
    fn = getattr(tsol, solver)
    x, info = fn(s.A, s.b, ortho="cgs2", **kw)
    for name in ("cgs2_fused", "cgs2_xla"):
        xo, io = fn(s.A, s.b, ortho=name, **kw)
        for key in ("steps", "constrained_steps", "safety"):
            assert io.get(key) == info.get(key), (name, key)
        torch_parity.close(xo.numpy(), x.numpy(), 1e-12)
