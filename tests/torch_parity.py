"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

Both packages compute on identical operands: a problem is assembled by the
JAX package, exported as numpy arrays, and rebuilt in the port through
``structurepreservingiterativesolvers_torch.interop``.  Everything runs on
the CPU in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from structurepreservingiterativesolvers_torch import interop

# the suite runs several pytest workers side by side
torch.set_num_threads(1)

LKDV_EASY = dict(degree=1, M=50, N=100)
LKDV_HARD = dict(degree=3, M=100, N=100)


def dia_triple(A):
    """A JAX DIA as the (data, offsets, wrap) triple the interop takes."""
    return np.asarray(A.data), tuple(A.offsets), bool(A.wrap)


def export_lkdv(s) -> dict:
    p = s.prob
    return {
        "A": dia_triple(s.A), "Mmat": dia_triple(s.Mmat),
        "Gmat": dia_triple(s.Gmat), "b": np.asarray(s.b),
        "z0": np.asarray(s.z0), "omega": np.asarray(s.omega),
        "m0": float(s.m0), "mo0": float(s.mo0), "e0": float(s.e0),
        "n0": s.n0, "N": p.N, "M": p.M, "degree": p.degree, "space": p.space,
        "T": p.T, "A_csr": s.A_csr,
    }


def export_swe(s) -> dict:
    p = s.prob
    return {
        "A": dia_triple(s.A), "b": np.asarray(s.b), "z0": np.asarray(s.z0),
        "omega": np.asarray(s.omega), "energy_scales": s.Lfull.scales,
        "m0": float(s.m0), "e0": float(s.e0), "n0": s.n0, "N": p.N,
        "M": p.M, "degree": p.degree, "T": p.T, "A_csr": s.A_csr,
    }


def to_port(jax_system):
    """The port's twin of a JAX lkdv or swe system, on the CPU."""
    if hasattr(jax_system, "Mmat"):
        return interop.lkdv_system(export_lkdv(jax_system), device="cpu")
    return interop.swe_system(export_swe(jax_system), device="cpu")


def rel_max(a, b) -> float:
    """max|a − b| / max|b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def perturbed(b, seed=0, size=1e-15):
    """b with a relative perturbation at the rounding level: the reference's
    own reproducibility under it sets the scale of the parity bounds."""
    b = np.asarray(b)
    rng = np.random.default_rng(seed)
    return b * (1.0 + size * rng.standard_normal(b.shape))
