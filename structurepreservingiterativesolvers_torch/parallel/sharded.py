"""Row-sharded operators: each rank holds its block of rows, and a product
fetches the part of x that its rows read from the ranks that own it.

The JAX package shards a DIA's ``data`` and an ELL's ``cols``/``vals`` on
their row axis and lets GSPMD partition the rolled-shift or gather product
(``parallel/mesh.py:39-62`` there).  Here the exchange is explicit:

* ``Exchange``, built once per operator from the columns each rank's rows
  read and the row split, assembles a rank's *window* ``x_ext``: the part
  that the rank owns is a local copy (never a message to itself), and each
  peer sends, in one ``all_to_all_single``, the elements of its block that
  fall in this rank's window, in the window's order, so that two parts of
  one window that one peer owns (the left and the right neighbour at two
  ranks, or a window wider than a shard) travel as one message;
* ``ShardedDIA``: the window of the rows [r0, r1) is [r0 - lo, r1 + hi),
  taken mod n where the DIA wraps and zero outside [0, n) where it does
  not, and the local product is kernel #1's windowed launch
  (``kernels/dia_spmv.py::window_launch``: each row sums the same
  diagonals in the same order as the unsharded launch, with the shard's
  own live plan), #1b for a block;
* ``ShardedELL``: the window is the sorted set of the columns its local rows
  reference, or the whole replicated input;
* ``ShardedScale`` (a diagonal operator, swe's energy matrix), ``Gathered``
  (any other operator or preconditioner: gather the vector, apply, keep the
  local rows: the JAX package's "replicated as-is"), and the AMG's box
  transfers between a sharded level and the next (``ShardedBoxProlong``,
  ``ShardedBoxRestrict``, through a coarse vector that every rank holds).

Every product takes a local vector (n_local,) or a block (n_local, B), the
JAX package's tall operand, and all ranks call it together (SPMD).

Each of them has its f64 product from f32 storage (``matvec_f64``, the f32
storage mode's certificates and f64 reductions, ``ops/sparse.py::
matvec_f64``): a ``ShardedDIA`` the mixed kernel #1's windowed launch on
the f32 window (f32 data, f64 y), a ``ShardedELL`` the upcast gather of its
window, a ``ShardedScale`` its f64 diagonal, a ``Gathered`` operator its
own f64 product of the gathered vector.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.dia_spmv import (
    DiaLaunch,
    LivePlan,
    dia_spmm_window_torch,
    dia_spmv_window_mixed_torch,
    dia_spmv_window_torch,
    launch,
    launch_many,
    launch_mixed,
    live_chunk,
    live_plan,
    window_launch,
)
from ..ops.sparse import ELL, ell_spmm, ell_spmv, f64_supported, matvec_f64
from .comm import Mesh, all_to_all_calls, gather

# a rank's own part of its window copied as slices up to this many runs,
# else through one index
MAX_RUNS = 16


class Exchange:
    """The assembly of a rank's window from the row blocks of x.

    ``want[p]`` (for every rank p of the mesh) holds the global column of
    each position of p's window, -1 where the position is zero; ``bounds``
    the row block [r0, r1) of every rank.  Every rank builds the same plan
    from the same arrays, so whether any message moves (``msgs``) is known
    alike on every rank, and every rank then calls the collective."""

    def __init__(self, want: Sequence[np.ndarray], bounds, mesh: Mesh):
        rank = mesh.rank
        starts = np.asarray([b[0] for b in bounds], np.int64)
        r0 = int(bounds[rank][0])

        def owner(g):
            o = np.searchsorted(starts, g, side="right") - 1
            return np.where(g >= 0, o, -1)

        mine = np.asarray(want[rank], np.int64)
        own = owner(mine)
        self.mesh, self.width = mesh, int(mine.shape[0])
        self.fill = bool((mine < 0).any())
        dev = mesh.device
        # this rank's own part: slices where it runs in few segments
        dst = np.nonzero(own == rank)[0]
        src = mine[dst] - r0
        cut = np.nonzero((np.diff(dst) != 1) | (np.diff(src) != 1))[0] + 1
        starts_run = np.concatenate([[0], cut]) if dst.size else np.zeros(0, np.int64)
        ends_run = np.concatenate([cut, [dst.size]]) if dst.size else np.zeros(0, np.int64)
        self.runs: List[Tuple[int, int, int]] = []
        self.own_dst = self.own_src = None
        if len(starts_run) <= MAX_RUNS:
            self.runs = [(int(dst[a]), int(src[a]), int(e - a))
                         for a, e in zip(starts_run, ends_run)]
        else:
            self.own_dst = torch.as_tensor(dst, device=dev)
            self.own_src = torch.as_tensor(src, device=dev)
        # the messages: from each peer q the positions of this window that
        # q owns, in order; to each peer p the elements of this block that
        # fall in p's window, in the order of p's positions
        recv_pos, send_idx = [], []
        self.recv_splits, self.send_splits = [], []
        msgs = False
        for p in range(mesh.size):
            wp = np.asarray(want[p], np.int64)
            op = owner(wp)
            msgs = msgs or bool(((op != p) & (op >= 0)).any())
            pos = np.nonzero(own == p)[0] if p != rank else np.zeros(0, np.int64)
            out = (wp[op == rank] - r0) if p != rank else np.zeros(0, np.int64)
            recv_pos.append(pos)
            send_idx.append(out)
            self.recv_splits.append(int(pos.size))
            self.send_splits.append(int(out.size))
        self.msgs = msgs
        self.recv_pos = torch.as_tensor(np.concatenate(recv_pos), device=dev)
        self.send_idx = torch.as_tensor(np.concatenate(send_idx), device=dev)

    @property
    def peers(self) -> Tuple[int, ...]:
        """The ranks this rank receives from."""
        return tuple(p for p, c in enumerate(self.recv_splits) if c)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The window (..., width) of x (..., n_local): the rows of a
        (B, n_local) block, or one vector."""
        lead = x.shape[:-1]
        make = torch.zeros if self.fill else torch.empty
        ext = make((*lead, self.width), dtype=x.dtype, device=x.device)
        for dst, src, ln in self.runs:
            ext[..., dst: dst + ln] = x[..., src: src + ln]
        if self.own_dst is not None:
            ext.index_copy_(ext.dim() - 1, self.own_dst,
                            x.index_select(-1, self.own_src))
        if self.msgs:
            import torch.distributed as dist

            send = x.index_select(-1, self.send_idx).movedim(-1, 0).contiguous()
            recv = send.new_empty((int(self.recv_pos.shape[0]), *lead))
            dist.all_to_all_single(recv, send, self.recv_splits,
                                   self.send_splits, group=self.mesh.group)
            all_to_all_calls.launches += 1
            ext.index_copy_(ext.dim() - 1, self.recv_pos, recv.movedim(0, -1))
        return ext


def window_wants(n: int, bounds, lo: int, hi: int, wrap: bool) -> List[np.ndarray]:
    """Every rank's DIA window [r0 - lo, r1 + hi): the column mod n where
    the operator wraps (the window may then hold a column more than once),
    -1 outside [0, n) where it does not."""
    wants = []
    for r0, r1 in bounds:
        g = np.arange(r0 - lo, r1 + hi, dtype=np.int64)
        wants.append(g % n if wrap else np.where((g >= 0) & (g < n), g, -1))
    return wants


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedDIA:
    """A DIA's rows [r0, r1) on this rank: ``data`` (ndiag, n_local), the
    global ``shape``, ``offsets`` and ``wrap``, the window's reach ``lo``
    and ``hi`` and its ``Exchange``.  ``A @ x`` takes the local rows of x;
    on the card the windowed kernel #1 (#1b for a block) with the shard's
    live plan where it pays, on the CPU its plain twin."""

    data: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    wrap: bool
    mesh: Mesh
    lo: int
    hi: int
    xchg: Exchange
    _plan: Optional[LivePlan] = dataclasses.field(default=None, init=False,
                                                  repr=False, compare=False)
    _launch: Optional[DiaLaunch] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def n_local(self) -> int:
        return self.data.shape[1]

    def matvec_f64(self, x: torch.Tensor) -> torch.Tensor:
        """The local rows of M x in f64 from f32 storage: the f32 window,
        then on the card the mixed kernel #1's windowed launch (f32 data
        and window, f64 products, sums and y; the shard's plan), on the CPU
        its plain twin; with f64 storage the product."""
        if self.dtype == torch.float64:
            return self @ x.double()
        ext = self.xchg(x)
        if ext.device.type == "cuda":
            return launch_mixed(self._resolved(ext), ext)
        return dia_spmv_window_mixed_torch(self.data, self.offsets, self.lo,
                                           ext)

    def f64_supported(self) -> bool:
        return True

    def live(self) -> LivePlan:
        if self._plan is None:
            object.__setattr__(self, "_plan",
                               live_plan(self.data, live_chunk(self.dtype)))
        return self._plan

    def _resolved(self, x_ext: torch.Tensor) -> DiaLaunch:
        rec = self._launch
        if rec is None or not rec.takes(x_ext):
            plan = self.live()
            like = x_ext if x_ext.dim() == 1 else x_ext.new_empty(self.xchg.width)
            rec = window_launch(self.data, self.offsets, self.lo, self.hi, like,
                                plan if plan.pays else None)
            object.__setattr__(self, "_launch", rec)
        return rec

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """The window of x (n_local,), or of each row of a (B, n_local)
        block."""
        return self.xchg(x)

    def local(self, x_ext: torch.Tensor) -> torch.Tensor:
        """The product of the local rows with a window (W,), or with a
        block of windows (W, B): kernel #1 or #1b windowed on the card,
        their plain twins on the CPU."""
        if x_ext.dim() == 1:
            if x_ext.device.type == "cuda":
                return launch(self._resolved(x_ext), x_ext)
            return dia_spmv_window_torch(self.data, self.offsets, self.lo, x_ext)
        if x_ext.device.type == "cuda":
            return launch_many(self._resolved(x_ext), x_ext)
        return dia_spmm_window_torch(self.data, self.offsets, self.lo, x_ext)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            return self.local(self.xchg(x))
        # the exchange runs on the block's (B, n_local) rows
        return self.local(self.xchg(x.T).T)


def shard_dia(A, mesh: Mesh) -> ShardedDIA:
    """This rank's rows of a DIA, with the exchange plan of its window."""
    n = A.shape[0]
    bounds = mesh.split(n)
    r0, r1 = bounds[mesh.rank]
    offs = tuple(int(o) for o in A.offsets)
    lo = max(0, -min(offs)) if offs else 0
    hi = max(0, max(offs)) if offs else 0
    xchg = Exchange(window_wants(n, bounds, lo, hi, A.wrap), bounds, mesh)
    data = A.data[:, r0:r1].contiguous().to(mesh.device)
    return ShardedDIA(data, offs, tuple(A.shape), bool(A.wrap), mesh, lo, hi,
                      xchg)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedELL:
    """An ELL's output rows on this rank (all of them where its output is
    replicated): ``local``, an ELL whose columns index the window that
    ``xchg`` assembles (the sorted set of the columns these rows read), or
    the whole input where the input is replicated (``xchg`` None)."""

    local: ELL
    shape: Tuple[int, int]
    mesh: Mesh
    xchg: Optional[Exchange]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            ext = self.xchg(x) if self.xchg is not None else x
            return ell_spmv(self.local, ext)
        if self.xchg is None:
            return ell_spmm(self.local, x)
        return ell_spmm(self.local, self.xchg(x.T).T)

    def matvec_f64(self, x: torch.Tensor) -> torch.Tensor:
        """The local rows in f64 from f32 storage: the upcast gather of the
        window (``ops/sparse.py::matvec_f64``'s ELL product)."""
        return matvec_f64(self.local, self.xchg(x) if self.xchg is not None
                          else x)

    def f64_supported(self) -> bool:
        return True


def shard_ell(A: ELL, mesh: Mesh, rows: bool = True,
              cols: bool = True) -> ShardedELL:
    """This rank's rows of an ELL (all rows where ``rows`` is false: a
    replicated output), reading a row-sharded input where ``cols`` (through
    the exchange of the columns its rows reference), else a replicated
    one."""
    n_out, n_in = A.shape
    out_bounds = mesh.split(n_out) if rows else None
    a, b = out_bounds[mesh.rank] if rows else (0, n_out)
    C = A.cols.cpu().numpy()
    vals = A.vals[:, a:b].contiguous().to(mesh.device)
    if not cols:
        local = ELL(torch.as_tensor(C[:, a:b].copy(), device=mesh.device),
                    vals, (b - a, n_in))
        return ShardedELL(local, tuple(A.shape), mesh, None)
    in_bounds = mesh.split(n_in)
    spans = out_bounds if rows else [(0, n_out)] * mesh.size
    wants = [np.unique(C[:, p0:p1]) for p0, p1 in spans]
    mine = wants[mesh.rank]
    pos = np.searchsorted(mine, C[:, a:b])
    local = ELL(torch.as_tensor(pos, device=mesh.device), vals,
                (b - a, int(mine.size)))
    return ShardedELL(local, tuple(A.shape), mesh,
                      Exchange(wants, in_bounds, mesh))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedScale:
    """A diagonal operator on row-sharded vectors: ``d`` (n_local,), this
    rank's rows of its diagonal."""

    d: torch.Tensor
    shape: Tuple[int, int]
    mesh: Mesh
    # d in another storage dtype, kept per dtype
    _cast: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def _d(self, dtype: torch.dtype) -> torch.Tensor:
        if dtype == self.d.dtype:
            return self.d
        if dtype not in self._cast:
            self._cast[dtype] = self.d.to(dtype)
        return self._cast[dtype]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        d = self._d(x.dtype)
        return d * x if x.dim() == 1 else d[:, None] * x

    def matvec_f64(self, x: torch.Tensor) -> torch.Tensor:
        """The f64 diagonal times the upcast x (``models/swe.py::
        _EnergyDiag.matvec_f64``)."""
        d = self._d(torch.float64)
        xd = x.double()
        return d * xd if x.dim() == 1 else d[:, None] * xd

    def f64_supported(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True, eq=False)
class Gathered:
    """An operator or a preconditioner that every rank holds whole, on
    row-sharded vectors: gather the vector (or the (n_local, B) block),
    apply, keep the local rows (``n``: the global rows)."""

    op: Any
    mesh: Mesh
    n: int

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        from ..precond.base import apply_preconditioner

        r0, r1 = self.mesh.rows(self.n)
        y = apply_preconditioner(self.op, gather(v, self.mesh))
        return y[r0:r1]

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)

    def matvec_f64(self, v: torch.Tensor) -> torch.Tensor:
        """The local rows of the operator's f64 product of the gathered
        vector (``ops/sparse.py::matvec_f64``)."""
        r0, r1 = self.mesh.rows(self.n)
        return matvec_f64(self.op, gather(v, self.mesh))[r0:r1]

    def f64_supported(self) -> bool:
        return f64_supported(self.op)


def _box_repeat(T, e: torch.Tensor) -> torch.Tensor:
    """P0 e on the fine grid (``BoxProlong.rows`` before its smoother)."""
    b = T.b
    E = e.reshape(T.Cc1, 1, T.Cc2, 1).expand(T.Cc1, b, T.Cc2, b).reshape(
        T.Cc1 * b, T.Cc2 * b)
    return E[: T.C1, : T.C2].reshape(T.C1 * T.C2)


def _box_sum(T, W: torch.Tensor) -> torch.Tensor:
    """P0ᵀ W on the coarse grid (``BoxRestrict.rows`` after its smoother)."""
    import torch.nn.functional as F

    b = T.b
    W = W.reshape(T.C1, T.C2)
    W = F.pad(W, (0, b * T.Cc2 - T.C2, 0, b * T.Cc1 - T.C1))
    Wc = W.reshape(b * T.Cc1, T.Cc2, b).sum(-1)
    return Wc.reshape(T.Cc1, b, T.Cc2).sum(-2).reshape(T.Cc1 * T.Cc2)


def _vector_only(x: torch.Tensor, what: str) -> None:
    if x.dim() != 1:
        raise NotImplementedError(
            f"{what} on a block under a mesh: a sharded AMG applies to one "
            "vector (cgmres_many takes no mesh, as in the JAX package)")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBoxProlong:
    """``BoxProlong`` from a coarse level (sharded where ``coarse_sharded``,
    else held whole by every rank) to this rank's rows of a sharded fine
    level: the box repeat of the whole coarse vector, this rank's rows of
    it, then the sharded smoother ``S``."""

    T: Any
    S: Any
    mesh: Mesh
    coarse_sharded: bool

    def __matmul__(self, e: torch.Tensor) -> torch.Tensor:
        _vector_only(e, "a box prolongation")
        if self.coarse_sharded:
            e = gather(e, self.mesh)
        r0, r1 = self.mesh.rows(self.T.C1 * self.T.C2)
        return self.S @ _box_repeat(self.T, e)[r0:r1].contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBoxRestrict:
    """``BoxRestrict`` from this rank's rows of a sharded fine level: the
    sharded smoother ``S``, the gathered result's box sums, and this rank's
    rows of them where the coarse level is sharded (every coarse row
    otherwise)."""

    T: Any
    S: Any
    mesh: Mesh
    coarse_sharded: bool

    def __matmul__(self, r: torch.Tensor) -> torch.Tensor:
        _vector_only(r, "a box restriction")
        coarse = _box_sum(self.T, gather(self.S @ r, self.mesh))
        if not self.coarse_sharded:
            return coarse
        c0, c1 = self.mesh.rows(coarse.shape[0])
        return coarse[c0:c1]
