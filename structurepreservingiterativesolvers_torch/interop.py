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
  ``N``, ``M``, ``degree``, ``T``; optionally ``A_csr``;
* heat: ``A`` (the explicit DIA of the JAX package's Stencil, decomposed
  again here by ``maybe_stencil``), ``Mmat``, ``Lmat``, ``Emat``; ``b``,
  ``z0``, ``Lz0``, ``omega``; ``m0``, ``e0``, ``old_energy``; ``N``, ``M``,
  ``degree``, ``T``; optionally ``A_csr``;
* lkdvrk: ``A_csr``, ``Mmat`` and ``Gmat`` as scipy CSR matrices (the
  device formats are picked again here by ``from_scipy``, as the JAX package
  picks them); ``Minv`` as the BSR triple ``(blocks, block_rows,
  block_cols)``; ``b``, ``z0``, ``omega``; ``m0``, ``mo0``, ``e0``; ``n0``;
  ``N``, ``M``, ``degree``, ``tstages``, ``space``, ``T``.  A fixture
  (``models/fixtures.py``) gives ``A_csr``, ``b`` and ``z0``.

An exported block preconditioner is its index blocks ``idx`` (nb, bs), its
inverses ``inv`` (nb, bs, bs) and, for RAS, its ownership mask ``own``.

An exported AMG hierarchy (``amg_hierarchy``) is the list of its levels,
each a dict of numpy arrays and sizes: ``A`` (the level operator's
``(data, offsets)``), ``dinv`` and ``omega``, and on every level but the
coarsest the smoother bands ``SP`` and ``SR`` and the grid sizes ``C1``,
``C2``, ``Cc1``, ``Cc2`` and ``box``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_DTYPE
from .models import heat, lkdv, lkdvrk, swe
from .ops.sparse import BSR, DIA, from_scipy
from .ops.stencil import maybe_stencil
from .precond.amg import AMG, BoxProlong, BoxRestrict, _Level
from .precond.jacobi import RAS, BlockJacobi


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


def heat_system(arrays: dict, *, device) -> heat.System:
    a = arrays
    prob = heat.Problem(N=a["N"], M=a["M"], degree=a["degree"], T=float(a["T"]))
    return heat.System(
        A=maybe_stencil(dia(*a["A"], device=device)),
        b=_tensor(a["b"], device),
        z0=_tensor(a["z0"], device),
        Mmat=dia(*a["Mmat"], device=device),
        Lmat=dia(*a["Lmat"], device=device),
        Emat=dia(*a["Emat"], device=device),
        Lz0=_tensor(a["Lz0"], device),
        omega=_tensor(a["omega"], device),
        m0=_tensor(a["m0"], device),
        e0=_tensor(a["e0"], device),
        old_energy=_tensor(a["old_energy"], device),
        prob=prob,
        A_csr=a.get("A_csr"),
    )


def _index(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)


def lkdvrk_system(arrays: dict, *, device) -> lkdvrk.System:
    a = arrays
    prob = lkdvrk.Problem(N=a["N"], M=a["M"], degree=a["degree"],
                          tstages=a["tstages"], space=a["space"],
                          T=float(a["T"]))
    fem = prob.fem()
    blocks, rows, cols = a["Minv"]
    n0 = int(a["n0"])
    return lkdvrk.System(
        A=maybe_stencil(from_scipy(a["A_csr"], device=device)),
        b=_tensor(a["b"], device),
        z0=_tensor(a["z0"], device),
        Mmat=from_scipy(a["Mmat"], device=device),
        Gmat=from_scipy(a["Gmat"], device=device),
        Minv=BSR(_tensor(blocks, device), _index(rows, device),
                 _index(cols, device), (n0, n0)),
        omega=_tensor(a["omega"], device),
        m0=_tensor(a["m0"], device),
        mo0=_tensor(a["mo0"], device),
        e0=_tensor(a["e0"], device),
        prob=prob,
        n0=n0,
        fem=fem,
        A_csr=a["A_csr"],
        Mh=fem.mass(),
    )


def block_jacobi_from_arrays(idx, inv, *, device) -> BlockJacobi:
    return BlockJacobi(idx=_index(idx, device), inv=_tensor(inv, device))


def ras_from_arrays(idx, inv, own, *, device) -> RAS:
    return RAS(idx=_index(idx, device), inv=_tensor(inv, device),
               own=torch.tensor(np.asarray(own, dtype=bool), device=device))


def amg_hierarchy(levels, coarse_inv, nu: int, *, device) -> AMG:
    """The port's AMG on the exported levels of a JAX hierarchy, so the
    V-cycle can be compared apart from the setup."""
    out = []
    for lv in levels:
        A = dia(lv["A"][0], lv["A"][1], False, device=device)
        dinv = _tensor(lv["dinv"], device)
        if "SP" not in lv:
            out.append(_Level(A=A, P=None, R=None, dinv=dinv,
                                   omega=float(lv["omega"])))
            continue
        grid = dict(C1=int(lv["C1"]), C2=int(lv["C2"]), b=int(lv["box"]),
                    Cc1=int(lv["Cc1"]), Cc2=int(lv["Cc2"]))
        out.append(_Level(
            A=A,
            P=BoxProlong(S=dia(lv["SP"], A.offsets, False, device=device),
                              **grid),
            R=BoxRestrict(S=dia(lv["SR"], A.offsets, False, device=device),
                               **grid),
            dinv=dinv,
            omega=float(lv["omega"]),
        ))
    return AMG(levels=tuple(out), coarse_inv=_tensor(coarse_inv, device),
                    nu=int(nu))
