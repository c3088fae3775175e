"""The mesh of a row-sharded solve, and the reductions over it.

The JAX package places the row dimension of every operator and vector on a
1-D device mesh (``NamedSharding``) and lets GSPMD insert the collectives:
a psum for every n-length inner product and norm, a collective permute for
the shifted reads of a DIA product (``parallel/mesh.py`` there).  The port
writes that program out, one process per device (SPMD), with
``torch.distributed`` underneath: NCCL for CUDA tensors, gloo for CPU
tensors.  A ``Mesh`` is the group of the ranks that hold the rows and this
rank's place in it; each rank holds its block of rows of every operator and
vector (``Mesh.split``: equal blocks, and an n that the ranks do not
divide is refused, as the JAX package's ``device_put`` refuses it).

Every n-length reduction of the solvers goes through ``psum`` (or
``pdot``, ``pnorm``), which all-reduces over the mesh and is the identity
without one (``mesh=None``: the unsharded path keeps its bits).  The
solvers find the mesh on the operator (``mesh_of``).  An all-reduce gives
every rank the same bits, so every flag, tolerance test and latch that the
solvers derive from reductions takes the same branch on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

ROWS = "rows"


class Collectives:
    """A count of one kind of collective, as the kernels count their
    launches (``utils.counters.all_counters`` lists it beside them, so a
    CUDA graph's replays count the collectives they hold): ``launches``
    goes up by one at each call on a mesh."""

    def __init__(self, name: str):
        self.name, self.launches = name, 0


all_reduce_calls = Collectives("all_reduce")
all_gather_calls = Collectives("all_gather")
all_to_all_calls = Collectives("all_to_all")


def collective_counters() -> dict:
    """The collectives' counters, by name."""
    return {c.name: c for c in (all_reduce_calls, all_gather_calls,
                                all_to_all_calls)}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh named ``("rows",)`` over the ranks of ``group`` (the
    world's default group where None): ``rank`` is this process's place in
    it, ``size`` the number of ranks, ``device`` the device of its shards,
    ``backend`` the group's (``"nccl"`` or ``"gloo"``)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str

    axis_names = (ROWS,)

    @property
    def shape(self) -> dict:
        return {ROWS: self.size}

    def split(self, n: int) -> Tuple[Tuple[int, int], ...]:
        """The row blocks [r0, r1) of every rank for n rows: equal blocks;
        an n that the ranks do not divide is refused."""
        if n % self.size:
            raise ValueError(f"n={n} not divisible by {self.size} devices")
        s = n // self.size
        return tuple((p * s, (p + 1) * s) for p in range(self.size))

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's block of n rows."""
        return self.split(n)[self.rank]


def mesh_of(*objs) -> Optional[Mesh]:
    """The mesh of the first object that has one (a sharded operator, a
    constraint on sharded data), else None."""
    for o in objs:
        m = getattr(o, "mesh", None)
        if m is not None:
            return m
    return None


def psum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of t over the mesh's ranks, in place (t is a fresh result),
    on PyTorch's current stream; t itself without a mesh."""
    if mesh is None:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, group=mesh.group)
    all_reduce_calls.launches += 1
    return t


def pmax(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise maximum of t over the mesh's ranks, in place (t is a
    fresh result); t itself without a mesh."""
    if mesh is None:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    all_reduce_calls.launches += 1
    return t


def pdot(a: torch.Tensor, b: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The dot product of two row-sharded vectors."""
    return psum(torch.dot(a, b), mesh)


def pnorm(v: torch.Tensor, mesh: Optional[Mesh], dim=None) -> torch.Tensor:
    """The 2-norm of a row-sharded vector (over ``dim``, the last axis of
    a block): ``torch.linalg.norm`` without a mesh, else the square root of
    the all-reduced sum of squares."""
    if mesh is None:
        return torch.linalg.norm(v) if dim is None else torch.linalg.norm(v, dim=dim)
    sq = (v * v).sum() if dim is None else (v * v).sum(dim)
    return torch.sqrt(psum(sq, mesh))


def gather(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """The full tensor from every rank's block along ``dim`` (the rows: 0
    for a vector or an (n, B) block, -1 for a (B, n) block), in rank order;
    x itself without a mesh."""
    if mesh is None:
        return x
    import torch.distributed as dist

    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
    # all_gather_into_tensor's newer name, where the installed torch has it
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=mesh.group)
    all_gather_calls.launches += 1
    return out.movedim(0, dim)
