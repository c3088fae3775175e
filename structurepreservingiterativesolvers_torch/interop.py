"""Build the port's systems from plain arrays exported by the JAX package.

The parity tests assemble a problem with the JAX package, hand its operands
over as numpy arrays and scalars, and rebuild them here, so both packages
compute on identical operands.  Nothing here imports JAX: the caller does
the export (``tests/torch_parity.py``).

An exported DIA operator is the triple ``(data, offsets, wrap)``.  A system
is a dict:

* lkdv: ``A``, ``Mmat``, ``Gmat`` (DIA triples); ``b``, ``z0``, ``omega``;
  the invariant targets ``m0``, ``mo0``, ``e0``; ``n0``; the problem
  parameters ``N``, ``M``, ``degree``, ``space``, ``T``; optionally
  ``A_csr`` for the direct solve;
* swe: ``A``; ``b``, ``z0``, ``omega``; the energy weights
  ``energy_scales`` (three per-field factors); ``m0``, ``e0``; ``n0``;
  ``N``, ``M``, ``degree``, ``T``; optionally ``A_csr``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_DTYPE
from .models import lkdv, swe
from .ops.sparse import DIA


def dia(data, offsets, wrap, *, device, dtype=DEFAULT_DTYPE) -> DIA:
    data = np.asarray(data)
    n = data.shape[1]
    return DIA(torch.tensor(data, dtype=dtype, device=device),
               tuple(int(o) for o in offsets), (n, n), bool(wrap))


def _tensor(a, device, dtype=DEFAULT_DTYPE) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def lkdv_system(arrays: dict, *, device) -> lkdv.System:
    a = arrays
    prob = lkdv.Problem(N=a["N"], M=a["M"], degree=a["degree"],
                        space=a["space"], T=float(a["T"]))
    return lkdv.System(
        A=dia(*a["A"], device=device),
        b=_tensor(a["b"], device),
        z0=_tensor(a["z0"], device),
        Mmat=dia(*a["Mmat"], device=device),
        Gmat=dia(*a["Gmat"], device=device),
        omega=_tensor(a["omega"], device),
        m0=_tensor(a["m0"], device),
        mo0=_tensor(a["mo0"], device),
        e0=_tensor(a["e0"], device),
        prob=prob,
        n0=int(a["n0"]),
        A_csr=a.get("A_csr"),
    )


def swe_system(arrays: dict, *, device) -> swe.System:
    a = arrays
    prob = swe.Problem(N=a["N"], M=a["M"], degree=a["degree"], T=float(a["T"]))
    return swe.System(
        A=dia(*a["A"], device=device),
        b=_tensor(a["b"], device),
        z0=_tensor(a["z0"], device),
        omega=_tensor(a["omega"], device),
        Lfull=swe._EnergyDiag(tuple(float(s) for s in a["energy_scales"]),
                              int(a["n0"])),
        m0=_tensor(a["m0"], device),
        e0=_tensor(a["e0"], device),
        prob=prob,
        n0=int(a["n0"]),
        A_csr=a.get("A_csr"),
    )
