"""The explicit ring-halo DIA SpMV (the port of the JAX package's
``parallel/halo_spmv.py``): rows are partitioned across the mesh, each rank
receives only its halo segments (the max |offset| values) from its ring
neighbours, and the stencil is applied locally.  Communication per SpMV is
2·halo per rank.

It keeps the JAX package's conditions: n divisible by the ranks, and a halo
no wider than a shard (``halo_spmv.py:67-72`` there).  Under them the
window of a ``ShardedDIA`` (``parallel/sharded.py``) reaches the two ring
neighbours only, so this is that operator's exchange plan, restricted to
them, and the same windowed launch of kernel #1.  Periodic (wrapping)
matrices map onto the ring; non-wrapping ones zero the global edges.  At
two ranks the left and the right neighbour are one peer: its two halo
segments travel as one message, in the window's order.
"""

from __future__ import annotations

import dataclasses

import torch

from .comm import Mesh
from .sharded import ShardedDIA


@dataclasses.dataclass(frozen=True, eq=False)
class HaloDia:
    """A row-sharded DIA whose SpMV uses the ring-halo schedule: a drop-in
    ``A`` for the solvers (``A @ x`` on the local rows of x)."""

    A: ShardedDIA
    mesh: Mesh

    @property
    def shape(self):
        return self.A.shape

    @property
    def offsets(self):
        return self.A.offsets

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            return dia_spmv_halo(self.A, x, self.mesh)
        # a tall block goes through the sharded operator's own exchange
        return self.A @ x


def dia_spmv_halo(A, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """y = A @ x with row-partitioned data and x (this rank's rows) and the
    ring-halo exchange.  ``A``: a ``ShardedDIA`` (``shard_matrix``), or a
    whole DIA, which is sharded here."""
    from .mesh import shard_matrix

    nd = mesh.size
    n = A.shape[0]
    if n % nd:
        raise ValueError(f"n={n} not divisible by {nd} devices")
    lo = -min(min(A.offsets), 0)
    hi = max(max(A.offsets), 0)
    if max(lo, hi) > n // nd:
        raise ValueError("halo wider than a local shard")
    return shard_matrix(A, mesh) @ x
