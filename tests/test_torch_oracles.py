"""The ILU and direct oracles and the native host kernels of the PyTorch port,
on the CPU in f64:

* ``ilu_oracle`` (scipy ``spilu`` with the reference's ``drop_tol=1e-4``,
  ``fill_factor=10``, densified) and ``direct_oracle`` against the JAX
  package's on the same scipy matrix (lkdvRK M=20, (3, 2)): ``Minv`` within
  1e-12, and the apply on a vector and a block;
* GMRES (k=60, tol=1e-8) on lkdvRK M=50, (3, 2) with each oracle: the
  steps of ``reference/slice13.json``;
* ``utils/native.py``: ``csr_spmv`` and ``ILU0`` against scipy on a
  tridiagonal matrix (its ILU(0) has no fill, so it is the exact LU), the
  library built under ``build/native/`` and ``native/`` left as it was.
  Skipped only where ``g++`` is missing.
"""

import hashlib
import importlib
import json
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_parity

# the module (the precond package exports a function of the same name,
# as the JAX package's does)
toracle = importlib.import_module(
    "structurepreservingiterativesolvers_torch.precond.ilu_oracle")

REC = json.loads((torch_parity.ROOT / "structurepreservingiterativesolvers_torch"
                  / "reference" / "slice13.json").read_text())


@pytest.mark.parametrize("which", ["ilu_oracle", "direct_oracle"])
def test_oracle_matches_jax(which):
    from structurepreservingiterativesolvers_tpu.models import lkdvrk

    # the JAX package's precond namespace exports a function of this name
    joracle = importlib.import_module(
        "structurepreservingiterativesolvers_tpu.precond.ilu_oracle")

    s = lkdvrk.linforms(M=20, degree=3, tstages=2)
    pj = getattr(joracle, which)(s.A_csr)
    pt = getattr(toracle, which)(s.A_csr, device="cpu")
    assert pt.Minv.dtype == torch.float64
    torch_parity.close(pt.Minv.numpy(), np.asarray(pj.Minv), 1e-12)
    rng = np.random.default_rng(4)
    v, V = rng.standard_normal(pt.Minv.shape[0]), rng.standard_normal(
        (pt.Minv.shape[0], 3))
    torch_parity.close(pt(torch.as_tensor(v)).numpy(), np.asarray(pj(v)),
                       1e-12)
    # a block's column against the vector apply (another BLAS product)
    torch_parity.close(pt.solve(torch.as_tensor(V))[:, 1].numpy(),
                       pt(torch.as_tensor(V[:, 1])).numpy(), 1e-12)


def test_oracle_gmres_steps_match_record():
    from structurepreservingiterativesolvers_torch.models import lkdvrk
    from structurepreservingiterativesolvers_torch.solvers import gmres

    rec = REC["lkdvrk_M50_ilu"]
    cfg = rec["config"]
    s = lkdvrk.linforms(M=cfg["M"], degree=cfg["degree"],
                        tstages=cfg["tstages"], device="cpu")
    for label, oracle in (("ilu", toracle.ilu_oracle),
                          ("direct", toracle.direct_oracle)):
        _, info = gmres(s.A, s.b, k=cfg["k"], tol=cfg["tol"],
                        pre=oracle(s.A_csr, device="cpu"))
        assert info["steps"] == rec[label]["steps"], label
        assert info["res"][-1] < cfg["tol"]


def _tree_hash(path):
    h = hashlib.sha256()
    for p in sorted(path.rglob("*")):
        if p.is_file():
            h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()


def test_native_kernels_match_scipy():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build native/spkernels.cpp")
    from structurepreservingiterativesolvers_torch.utils import native

    before = _tree_hash(torch_parity.ROOT / "native")
    assert native.available()
    lib = native.library_path()
    assert lib.is_file()
    assert lib.parent == torch_parity.ROOT / "build" / "native"
    rng = np.random.default_rng(5)
    n = 120
    A = sp.csr_matrix(sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)))
    x = rng.standard_normal(n)
    np.testing.assert_allclose(native.csr_spmv(A, x), A @ x, rtol=1e-14)
    # tridiagonal ILU(0) has no fill: the exact LU
    b = rng.standard_normal(n)
    np.testing.assert_allclose(A @ native.ILU0(A).solve(b), b, rtol=1e-10,
                               atol=1e-12)
    # a general sparse matrix: the product row by row as scipy's
    R = sp.random(80, 80, density=0.1, random_state=6, format="csr") + sp.eye(80)
    y = rng.standard_normal(80)
    np.testing.assert_allclose(native.csr_spmv(R.tocsr(), y), R @ y,
                               rtol=1e-13, atol=1e-13)
    assert _tree_hash(torch_parity.ROOT / "native") == before
