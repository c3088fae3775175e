"""Device-mesh construction and system sharding (the port of the JAX
package's ``parallel/mesh.py``).

The JAX package builds a 1-D ``Mesh`` over the chips, places the row
dimension of every operator and vector on it and runs the same jitted
solver: GSPMD inserts the collectives.  The port is that program written
out, one process per device: ``make_mesh`` is a 1-D mesh over the ranks of
the ``torch.distributed`` world (``parallel/comm.py::Mesh``), each rank
holds its block of rows of every operator and vector (``shard_matrix``,
``shard_vector``), a product fetches the part of x its rows read from the
ranks that own it (``parallel/sharded.py``), every n-length reduction of
the solvers is all-reduced over the mesh (``parallel/comm.py::psum``), and
the k-sized work (Givens, LSQ, KKT) stays replicated and runs the same on
every rank.  The KKT endgame's data (t1, T2, H, R) is replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.sparse import DIA, ELL
from .comm import ROWS, Mesh, gather, mesh_of  # noqa: F401
from .sharded import (
    Gathered,
    ShardedBoxProlong,
    ShardedBoxRestrict,
    ShardedDIA,
    ShardedELL,
    ShardedScale,
    shard_dia,
    shard_ell,
)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The 1-D mesh ``("rows",)`` over the ranks of the distributed world,
    one device per rank: the default group, initialised on first use
    (``init_distributed``: a world of one process where none is set up).
    ``n_devices`` is the world's size or None; the device is this rank's
    CUDA device, or the CPU where the group is gloo.  ``devices`` is the
    JAX package's and is not taken (one process holds one device)."""
    import torch.distributed as dist

    from .distributed import init_distributed

    if devices is not None:
        raise NotImplementedError(
            "devices=: a rank of the port holds one device; start one "
            "process per device (spawn_local, or one launch per host)")
    if not dist.is_initialized():
        init_distributed()
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(
            f"a mesh of {n_devices} devices in a world of {size} processes: "
            "the port's mesh spans the world (one device per process); run "
            f"{n_devices} processes (spawn_local)")
    backend = str(dist.get_backend())
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(group=None, rank=dist.get_rank(), size=size, device=device,
                backend=backend)


def shard_matrix(A, mesh: Mesh):
    """This rank's rows of a sparse operator: a ``Stencil`` through its DIA
    (``as_dia``, as the JAX package: so a sharded heat operator runs kernel
    #1), a DIA as a ``ShardedDIA``, an ELL as a ``ShardedELL``; an operator
    already sharded as it is.  A BSR is refused, as the JAX package
    refuses it."""
    from ..ops.stencil import as_dia

    if isinstance(A, (ShardedDIA, ShardedELL)):
        return A
    A = as_dia(A)
    if isinstance(A, DIA):
        return shard_dia(A, mesh)
    if isinstance(A, ELL):
        return shard_ell(A, mesh)
    raise NotImplementedError(f"sharding for {type(A).__name__} not implemented")


def shard_vector(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a whole vector (or of the rows of an (n, B)
    block), on the mesh's device."""
    r0, r1 = mesh.rows(v.shape[0])
    return v[r0:r1].to(mesh.device).contiguous()


def replicated(x, mesh: Mesh):
    """x, held whole by every rank, on the mesh's device."""
    return x.to(mesh.device) if isinstance(x, torch.Tensor) else x


def _shard_operator(M, mesh: Mesh):
    """A constraint's operator on row-sharded vectors: a DIA, ELL or
    Stencil sharded, a combination by its terms, swe's diagonal energy
    matrix by its rows, anything else gathered (every rank holds it)."""
    from ..constraints.quadratic import MatComb
    from ..models.swe import _EnergyDiag
    from ..ops.stencil import Stencil

    if isinstance(M, (DIA, ELL, Stencil, ShardedDIA, ShardedELL)):
        return shard_matrix(M, mesh)
    if isinstance(M, MatComb):
        return dataclasses.replace(
            M, mats=tuple(_shard_operator(A, mesh) for A in M.mats))
    if isinstance(M, _EnergyDiag):
        d = torch.cat([torch.full((M.n0,), float(s), dtype=torch.float64)
                       for s in M.scales])
        return ShardedScale(shard_vector(d, mesh), (d.shape[0],) * 2, mesh)
    n = M.shape[0] if hasattr(M, "shape") else None
    if n is None:
        raise NotImplementedError(
            f"sharding a {type(M).__name__} operator of unknown size")
    return Gathered(M, mesh, int(n))


def shard_constraint(con, mesh: Mesh):
    """Shard a ``QuadraticConstraint``'s vector data row-wise; scalars
    replicate; its reductions then all-reduce over the mesh (the
    constraint's ``mesh``).  A ``GeneralConstraint`` is refused, as the
    JAX package's ``shard_constraint`` builds quadratic constraints only."""
    from ..constraints.quadratic import QuadraticConstraint

    if not isinstance(con, QuadraticConstraint):
        raise NotImplementedError(
            f"a {type(con).__name__} under a mesh: shard_constraint builds "
            "QuadraticConstraints only, as the JAX package's does")
    M = _shard_operator(con.M, mesh) if con.M is not None else None
    v = shard_vector(con.v, mesh) if con.v is not None else None
    return QuadraticConstraint(M=M, v=v, c=replicated(con.c, mesh),
                               name=con.name, mesh=mesh)


def shard_preconditioner(pre, mesh: Mesh, replicate_below: int = 32768):
    """Place a preconditioner's data on the mesh, as the JAX package does:

    * ``AMG``: levels with at least ``replicate_below`` rows (and a
      coarser level) are row-sharded, their operator, ``dinv`` and
      transfers; the other levels and the dense coarsest inverse are held
      whole by every rank.  A box transfer goes through the whole coarse
      vector (``ShardedBoxProlong``, ``ShardedBoxRestrict``);
    * ``Jacobi``: ``dinv`` row-sharded;
    * ``Chebyshev``, ``Neumann``, ``SkewNormalChebyshev``: a sharded A, run
      as chained sharded products: the fused kernels #3 and #4 are not
      used under a mesh (the JAX package drops their window);
    * anything else (RAS, BlockJacobi, the composite): held whole, applied
      to the gathered vector, its local rows kept (``Gathered``)."""
    from ..precond.amg import AMG, BoxProlong, BoxRestrict, _Level
    from ..precond.chebyshev import Chebyshev, Neumann, SkewNormalChebyshev
    from ..precond.jacobi import Jacobi

    if pre is None:
        return None
    if isinstance(pre, AMG):
        def sharded(L):
            return L.A.shape[0] >= replicate_below and L.P is not None

        def transfer(T, coarse_sharded, prolong):
            if isinstance(T, (BoxProlong, BoxRestrict)):
                S = shard_matrix(T.S, mesh)
                cls = ShardedBoxProlong if prolong else ShardedBoxRestrict
                return cls(T, S, mesh, coarse_sharded)
            if isinstance(T, ELL):
                # P: fine rows sharded, coarse input as the coarse level
                # holds it; R: coarse rows as the coarse level, fine input
                # sharded
                if prolong:
                    return shard_ell(T, mesh, rows=True, cols=coarse_sharded)
                return shard_ell(T, mesh, rows=coarse_sharded, cols=True)
            return shard_matrix(T, mesh)

        levels = []
        for i, L in enumerate(pre.levels):
            if sharded(L):
                nxt = sharded(pre.levels[i + 1])
                levels.append(_Level(
                    A=shard_matrix(L.A, mesh),
                    P=transfer(L.P, nxt, True),
                    R=transfer(L.R, nxt, False),
                    dinv=shard_vector(L.dinv, mesh),
                    omega=L.omega))
            else:
                levels.append(L)
        return dataclasses.replace(pre, levels=tuple(levels),
                                   coarse_inv=replicated(pre.coarse_inv, mesh))
    if isinstance(pre, Jacobi):
        return dataclasses.replace(pre, dinv=shard_vector(pre.dinv, mesh))
    if isinstance(pre, Chebyshev):
        return dataclasses.replace(pre, A=shard_matrix(pre.A, mesh), fused=False)
    if isinstance(pre, Neumann):
        return dataclasses.replace(pre, A=shard_matrix(pre.A, mesh),
                                   dinv=shard_vector(pre.dinv, mesh),
                                   fused=False)
    if isinstance(pre, SkewNormalChebyshev):
        return dataclasses.replace(pre, A=shard_matrix(pre.A, mesh))
    return Gathered(pre, mesh, _rows_of(pre))


def _rows_of(pre) -> int:
    """The rows a preconditioner applies to: its operator's, or its blocks'
    owned positions (RAS) or positions (BlockJacobi)."""
    if getattr(pre, "A", None) is not None:
        return int(pre.A.shape[0])
    if getattr(pre, "own", None) is not None:
        return int(pre.own.sum())
    if getattr(pre, "idx", None) is not None:
        return int(pre.idx.numel())
    raise NotImplementedError(
        f"sharding a {type(pre).__name__} preconditioner whose size is not "
        "known (no operator A, no blocks)")


def shard_system(A, b, x0, constraints, mesh: Mesh):
    """One-call sharding of a full solve problem onto the mesh."""
    return (
        shard_matrix(A, mesh),
        shard_vector(b, mesh),
        shard_vector(x0, mesh),
        tuple(shard_constraint(c, mesh) for c in constraints),
    )
