"""The greedy host AMG of the PyTorch port against the JAX package's, on the
same scipy matrices in f64: the aggregates of ``_aggregate`` (heat P2 and P1
at M=16, and an asymmetric operator), the hierarchy built without ``grid=``
on heat P2 (level sizes, formats, ``dinv``, the ELL transfers and the
coarse inverse), the host-structured hierarchy (``setup="host"`` with
``grid=``) on heat P1, one V-cycle on a vector and on a block (n, 3), the
diagonal of an ELL, and the aggregate counts of ``reference/slice13.json``
at heat P2 M=16 and M=64.

Tolerances: the host setup is the same numpy and scipy code in both
packages, so the aggregate ids are equal and the level data agree to
1e-12 relative; one V-cycle sums the ELL slots in another order, within
1e-10 relative.
"""

import hashlib
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.ops import sparse as tsp
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.ops.sparse import to_scipy

# the module (the precond package exports a function of the same name,
# as the JAX package's does)
tamg = importlib.import_module(
    "structurepreservingiterativesolvers_torch.precond.amg")

# each package's precond namespace exports functions of these names
jamg = importlib.import_module("structurepreservingiterativesolvers_tpu.precond.amg")
jjac = importlib.import_module(
    "structurepreservingiterativesolvers_tpu.precond.jacobi")
tjac = importlib.import_module(
    "structurepreservingiterativesolvers_torch.precond.jacobi")
_close = torch_parity.close


def _heat(M, degree):
    return jheat.linforms(M=M, degree=degree)


def _asymmetric():
    import test_torch_amg

    return test_torch_amg._asymmetric()


@pytest.mark.parametrize("which", ["heat_P2_M16", "heat_P1_M16", "asymmetric"])
def test_aggregate_ids_equal(which):
    A = (_asymmetric() if which == "asymmetric"
         else _heat(16, 2 if "P2" in which else 1).A_csr)
    np.testing.assert_array_equal(tamg._aggregate(A), jamg._aggregate(A))


def test_aggregate_counts_match_record():
    """Every level's aggregates of heat P2 at M=16 and M=64, as the JAX
    package's record counts and hashes them."""
    rec = json.loads((torch_parity.ROOT / "structurepreservingiterativesolvers_torch"
                      / "reference" / "slice13.json").read_text())
    from structurepreservingiterativesolvers_torch.models import heat

    for M in rec["heat_P2_aggregates"]["config"]["M"]:
        s = heat.linforms(M=M, degree=2, device="cpu")
        pre = tamg.amg(s.A_csr, device="cpu")
        got = []
        for L in pre.levels[:-1]:
            agg = tamg._aggregate(tsp.to_scipy(L.A))
            got.append({"n": L.A.shape[0], "aggregates": int(agg.max()) + 1,
                        "sha256": hashlib.sha256(agg.tobytes()).hexdigest()})
        assert got == rec["heat_P2_aggregates"][f"M{M}"]


def _same_operator(At, Aj):
    assert type(At).__name__ == type(Aj).__name__
    assert tuple(At.shape) == tuple(Aj.shape)
    if isinstance(At, tsp.ELL):
        np.testing.assert_array_equal(At.cols.numpy(), np.asarray(Aj.cols))
        _close(At.vals.numpy(), np.asarray(Aj.vals), 1e-12)
    else:
        assert At.offsets == tuple(Aj.offsets) and At.wrap == bool(Aj.wrap)
        _close(At.data.numpy(), np.asarray(Aj.data), 1e-12)


def test_greedy_hierarchy_matches_jax():
    """heat P2 M=32 without grid=: three levels, every one an ELL, the
    transfers ELL."""
    A = _heat(32, 2).A_csr
    pj = jamg.amg(A, dtype=np.float64)
    pt = tamg.amg(A, device="cpu")
    assert [L.A.shape[0] for L in pt.levels] == [4225, 373, 44]
    assert len(pt.levels) == len(pj.levels)
    for Lt, Lj in zip(pt.levels, pj.levels):
        _same_operator(Lt.A, Lj.A)
        _close(Lt.dinv.numpy(), np.asarray(Lj.dinv), 1e-12)
        assert (Lt.P is None) == (Lj.P is None)
        if Lt.P is not None:
            _same_operator(Lt.P, Lj.P)
            _same_operator(Lt.R, Lj.R)
    _close(pt.coarse_inv.numpy(), np.asarray(pj.coarse_inv), 1e-12)


def test_host_structured_hierarchy_matches_jax():
    """heat P1 M=16 with setup='host' and grid=: box transfers from scipy
    smoothers, the same levels as the JAX package's."""
    A = _heat(16, 1).A_csr
    pj = jamg.amg(A, dtype=np.float64, grid=(17, 17), setup="host")
    pt = tamg.amg(A, grid=(17, 17), setup="host", device="cpu")
    assert [L.A.shape[0] for L in pt.levels] == [289, 36]
    for Lt, Lj in zip(pt.levels, pj.levels):
        _same_operator(Lt.A, Lj.A)
        _close(Lt.dinv.numpy(), np.asarray(Lj.dinv), 1e-12)
        if Lt.P is not None:
            assert isinstance(Lt.P, tamg.BoxProlong)
            assert (Lt.P.C1, Lt.P.C2, Lt.P.b, Lt.P.Cc1, Lt.P.Cc2) == (
                Lj.P.C1, Lj.P.C2, Lj.P.b, Lj.P.Cc1, Lj.P.Cc2)
            _same_operator(Lt.P.S, Lj.P.S)
            _same_operator(Lt.R.S, Lj.R.S)
    _close(pt.coarse_inv.numpy(), np.asarray(pj.coarse_inv), 1e-12)
    v = np.random.default_rng(3).standard_normal(289)
    _close(pt(torch.as_tensor(v)).numpy(), np.asarray(pj(jnp.asarray(v))),
           1e-10)


def test_vcycle_matches_jax_on_a_vector_and_a_block():
    """One greedy V-cycle on heat P2 M=32 (ELL levels and transfers): on a
    vector, and on a block (n, 3) against the JAX apply under vmap, each
    column also equal to the vector apply."""
    A = _heat(32, 2).A_csr
    pj = jamg.amg(A, dtype=np.float64)
    pt = tamg.amg(A, device="cpu")
    rng = np.random.default_rng(1)
    v = rng.standard_normal(A.shape[0])
    _close(pt(torch.as_tensor(v)).numpy(), np.asarray(pj(jnp.asarray(v))),
           1e-10)
    V = rng.standard_normal((A.shape[0], 3))
    Yj = np.asarray(jax.vmap(pj, in_axes=1, out_axes=1)(jnp.asarray(V)))
    Yt = pt(torch.as_tensor(V))
    _close(Yt.numpy(), Yj, 1e-10)
    for b in range(3):
        _close(Yt[:, b].numpy(), pt(torch.as_tensor(V[:, b])).numpy(), 1e-12)


def test_ell_diagonal_matches_jax():
    """The diagonal of heat P2's ELL operator and of a coarse level, and of
    an ELL whose diagonal holds an explicit zero."""
    import scipy.sparse as sp

    from structurepreservingiterativesolvers_tpu.ops.sparse import (
        ell_from_scipy,
    )

    from structurepreservingiterativesolvers_torch.models import heat

    s = _heat(16, 2)
    ts = heat.linforms(M=16, degree=2, device="cpu")
    assert isinstance(ts.A, tsp.ELL) and ts.A.row_width == 19
    np.testing.assert_array_equal(ts.A.cols.numpy(), np.asarray(s.A.cols))
    np.testing.assert_array_equal(tjac.diagonal(ts.A).numpy(),
                                  np.asarray(jjac.diagonal(s.A)))
    np.testing.assert_array_equal(tjac.jacobi(ts.A).dinv.numpy(),
                                  np.asarray(jjac.jacobi(s.A).dinv))
    coarse = jamg.amg(s.A_csr, dtype=np.float64).levels[1].A
    tc = tsp.ell_from_scipy(to_scipy(coarse), device="cpu")
    np.testing.assert_array_equal(tjac.diagonal(tc).numpy(),
                                  np.asarray(jjac.diagonal(coarse)))
    # row 1 stores an explicit zero on the diagonal
    B = sp.csr_matrix((np.array([2.0, 1.0, 1.0, 0.0, 3.0, 1.0, 5.0]),
                       np.array([0, 1, 0, 1, 2, 1, 2]),
                       np.array([0, 2, 5, 7])), shape=(3, 3))
    Bj, Bt = ell_from_scipy(B), tsp.ell_from_scipy(B, device="cpu")
    np.testing.assert_array_equal(tjac.diagonal(Bt).numpy(),
                                  np.asarray(jjac.diagonal(Bj)))
    np.testing.assert_array_equal(tjac.diagonal(Bt).numpy(), [2.0, 0.0, 5.0])
