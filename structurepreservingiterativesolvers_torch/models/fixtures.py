"""Portable pre-assembled system fixtures (.npz).

A copy of the JAX package's ``models/fixtures.py`` for numpy and scipy, with
the port's device operators: a fixture stores the CSR operator, the
right-hand side, the initial vector and the constraint data, and
``load_fixture`` rebuilds a solve-ready ``(A, b, z0, constraints, A_csr)``
on a device.  Fixtures written by either package load in either.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_DTYPE
from ..constraints.quadratic import QuadraticConstraint
from ..ops.sparse import from_scipy


def _csr_fields(prefix: str, A) -> dict:
    A = sp.csr_matrix(A)
    return {
        f"{prefix}_data": A.data,
        f"{prefix}_indices": A.indices,
        f"{prefix}_indptr": A.indptr,
        f"{prefix}_shape": np.asarray(A.shape),
    }


def _csr_read(prefix: str, f) -> sp.csr_matrix:
    return sp.csr_matrix(
        (f[f"{prefix}_data"], f[f"{prefix}_indices"], f[f"{prefix}_indptr"]),
        shape=tuple(f[f"{prefix}_shape"]),
    )


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_fixture(path: str, system, problem: str) -> None:
    """Persist an assembled model ``System`` (lkdv, heat, swe, lkdvrk)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fields = _csr_fields("A", system.A_csr)
    fields["b"] = _host(system.b)
    fields["z0"] = _host(system.z0)
    fields["problem"] = np.asarray(problem)
    cons = system.constraints()
    fields["n_constraints"] = np.asarray(len(cons))
    for i, c in enumerate(cons):
        fields[f"con{i}_name"] = np.asarray(c.name)
        fields[f"con{i}_c"] = _host(c.c)
        if c.v is not None:
            fields[f"con{i}_v"] = _host(c.v)
        if c.M is not None:
            # materialised as CSR: fixtures are for portability, not speed
            if not hasattr(c.M, "todense"):
                raise NotImplementedError(
                    f"constraint operator {type(c.M).__name__} cannot be "
                    "materialised; save the model parameters instead")
            fields.update(_csr_fields(f"con{i}_M", _host(c.M.todense())))
    np.savez_compressed(path, **fields)


def load_fixture(path: str, dtype=DEFAULT_DTYPE, *, device):
    """A fixture on ``device``: ``(A, b, z0, constraints, A_csr)``."""
    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    with np.load(path, allow_pickle=False) as f:
        A_csr = _csr_read("A", f)
        cons = []
        for i in range(int(f["n_constraints"])):
            v = dev(f[f"con{i}_v"]) if f"con{i}_v" in f else None
            M = (from_scipy(_csr_read(f"con{i}_M", f), dtype=dtype,
                            device=device)
                 if f"con{i}_M_data" in f else None)
            cons.append(QuadraticConstraint(
                M=M, v=v, c=dev(f[f"con{i}_c"]), name=str(f[f"con{i}_name"])))
        b, z0 = dev(f["b"]), dev(f["z0"])
    return (from_scipy(A_csr, dtype=dtype, device=device), b, z0, tuple(cons),
            A_csr)
