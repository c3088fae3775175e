"""Smoothed-aggregation AMG preconditioner: a structured device setup and
the greedy host setup.

The port of the JAX package's ``precond/amg.py``, which stands in for the
reference's PyAMG Ruge–Stüben preconditioner on the heat problem (reference
heat/TimedSolve.py:30-31).  The apply is device code: weighted-Jacobi
smoothing, restriction and prolongation, and a dense coarsest solve.

Setup has two paths, as in the JAX package:

* **Structured, on the device** (``grid=``, heat P1).  Box aggregation of a
  grid-local stencil operator yields Galerkin coarse operators that are
  themselves grid-local stencils, so every coarse operator's DIA bands are
  recovered exactly by probing the composed operator ``R∘A∘P`` with one
  indicator vector per stencil colour: no host SpGEMM, no host power
  iteration.  The transfers are gather-free (``BoxProlong``/``BoxRestrict``:
  a DIA smoother plus repeat, pad and box-sum reshapes), and every level
  operator and smoother is a DIA, so on the card each of their products is
  a launch of the DIA kernel.
* **On the host** (no ``grid=``, ``setup="host"``, or the ``auto``
  fallback when the structured setup refuses): greedy strength-graph
  aggregation (``_aggregate``) and scipy SpGEMM Galerkin products, the
  transfers in the ELL format (``ops/sparse.py::ELL``), each level's
  operator in the format ``from_scipy`` picks, DIA or ELL, as the JAX
  package's does.  With ``setup="host"`` and ``grid=`` the host builds the
  box transfers of the structured path from scipy smoothers.  This is the
  path of unstructured operators: heat P2, whose operator is an ELL of
  width 19.  An ELL product is a gather and a weighted sum, plain XLA in
  the JAX package and torch operations here; a DIA level's product is a
  launch of the DIA kernel on the card.

The apply takes a vector or a block (n, B), the JAX package's operand under
``jax.vmap``: the V-cycle then runs on the B rows of a (B, n) block, the
layout of the device core's batch, so that every level's product reads the
(n, B) view of its block without a copy (the batched DIA kernel #1b on a DIA
level on the card, ``ell_spmm`` on an ELL one).  It reads nothing to the
host and allocates the same shapes on every call, so the device core
captures it in its CUDA graphs.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_DTYPE
from ..kernels.dia_spmv import shift
from ..ops.sparse import DIA, ELL, dia_from_scipy, ell_from_scipy, from_scipy
from ..ops.stencil import Stencil, as_dia


def _mv(A, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` (a DIA, an ELL, or a box transfer) for a vector, or on each
    row of a block x (B, n): the product with its (n, B) view."""
    return A @ x if x.dim() == 1 else (A @ x.T).T



@dataclasses.dataclass(frozen=True)
class BoxProlong:
    """Gather-free prolongation for grid-structured hierarchies:
    ``P e = S · (P0 e)`` with P0 the b×b-box aggregation indicator (a pure
    repeat/reshape on the grid) and S = I − ω_s D⁻¹A the smoothing matrix
    in DIA form."""

    S: Union[DIA, ELL]  # smoother on the fine level
    C1: int  # fine grid rows
    C2: int  # fine grid cols
    b: int  # box size
    Cc1: int  # coarse grid rows
    Cc2: int  # coarse grid cols

    def __matmul__(self, e: torch.Tensor) -> torch.Tensor:
        """P e for a vector, or for each column of a block (nc, B)."""
        return self.rows(e) if e.dim() == 1 else self.rows(e.T).T

    def rows(self, e: torch.Tensor) -> torch.Tensor:
        """P on the last axis: (..., nc) to (..., n).  The box repeat is a
        broadcast and a reshape."""
        lead, b = e.shape[:-1], self.b
        E = e.reshape(*lead, self.Cc1, 1, self.Cc2, 1).expand(
            *lead, self.Cc1, b, self.Cc2, b).reshape(
            *lead, self.Cc1 * b, self.Cc2 * b)
        Fg = E[..., : self.C1, : self.C2].reshape(*lead, self.C1 * self.C2)
        return _mv(self.S, Fg)


@dataclasses.dataclass(frozen=True)
class BoxRestrict:
    """Gather-free restriction: ``R r = P0ᵀ · (Sᵣ r)`` with
    Sᵣ = I − ω_s A D⁻¹ (the transpose smoother for symmetric A) in DIA form
    and P0ᵀ a pad + box-sum reshape."""

    S: Union[DIA, ELL]  # transpose smoother on the fine level
    C1: int
    C2: int
    b: int
    Cc1: int
    Cc2: int

    def __matmul__(self, r: torch.Tensor) -> torch.Tensor:
        """R r for a vector, or for each column of a block (n, B)."""
        return self.rows(r) if r.dim() == 1 else self.rows(r.T).T

    def rows(self, r: torch.Tensor) -> torch.Tensor:
        """R on the last axis: (..., n) to (..., nc)."""
        lead, b = r.shape[:-1], self.b
        W = _mv(self.S, r).reshape(*lead, self.C1, self.C2)
        W = F.pad(W, (0, b * self.Cc2 - self.C2, 0, b * self.Cc1 - self.C1))
        Wc = W.reshape(*lead, b * self.Cc1, self.Cc2, b).sum(-1)
        return Wc.reshape(*lead, self.Cc1, b, self.Cc2).sum(-2).reshape(
            *lead, self.Cc1 * self.Cc2)


@dataclasses.dataclass(frozen=True)
class _Level:
    A: Union[DIA, ELL]  # operator at this level
    # prolongation (box or ELL), None at the coarsest level
    P: Optional[Union[BoxProlong, ELL]]
    # restriction = Pᵀ (box or ELL), None at the coarsest level
    R: Optional[Union[BoxRestrict, ELL]]
    dinv: torch.Tensor  # inverse diagonal (for weighted Jacobi)
    omega: float  # smoothing weight


@dataclasses.dataclass(frozen=True)
class AMG:
    levels: Tuple[_Level, ...]
    coarse_inv: torch.Tensor  # dense inverse at the coarsest level
    nu: int  # pre/post smoothing sweeps

    def _cycle(self, lvl: int, b: torch.Tensor) -> torch.Tensor:
        """The V-cycle from level ``lvl`` on a vector b (n,), or on each row
        of a block b (B, n)."""
        L = self.levels[lvl]
        if L.P is None:
            if b.dim() == 1:
                return self.coarse_inv @ b
            return b @ self.coarse_inv.T
        x = torch.zeros_like(b)
        for _ in range(self.nu):  # pre-smooth (weighted Jacobi)
            x = x + L.omega * (L.dinv * (b - _mv(L.A, x)))
        r = b - _mv(L.A, x)
        ec = self._cycle(lvl + 1, _mv(L.R, r))
        x = x + _mv(L.P, ec)
        for _ in range(self.nu):  # post-smooth
            x = x + L.omega * (L.dinv * (b - _mv(L.A, x)))
        return x

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """The V-cycle on v (n,), or on each column of a block v (n, B),
        run on the rows of its (B, n) view."""
        return self._cycle(0, v) if v.dim() == 1 else self._cycle(0, v.T).T

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self(v)


class _StructuredSetupError(ValueError):
    """The operator is not a grid-local stencil at some level."""


def _aggregate(A, theta: float = 0.08) -> np.ndarray:
    """Greedy standard aggregation on the strength graph (the JAX package's
    ``_aggregate``): an aggregate id per node (≥ 0).

    Node j is a strong neighbour of i where |a_ij| ≥ θ·sqrt(|a_ii a_jj|).
    Pass 1 visits the nodes in order and makes an aggregate of each free
    node whose strong neighbours are all free, with those neighbours; pass 2
    attaches each node left over to the aggregate of its first aggregated
    strong neighbour, or makes it an aggregate of its own.  Both passes
    depend on the order of the visits, so they run in the JAX package's
    order, node by node, over Python lists (the adjacency lists are the
    sorted rows of the strength graph, as ``tolil().rows`` gives them)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    d = np.sqrt(np.abs(A.diagonal()))
    C = sp.csr_matrix(A, copy=True)
    C.setdiag(0)
    C.eliminate_zeros()
    rows, cols = C.nonzero()
    strong = np.abs(C[rows, cols]).A1 >= theta * d[rows] * d[cols]
    S = sp.csr_matrix((np.ones(strong.sum()), (rows[strong], cols[strong])),
                      shape=(n, n))
    S.sum_duplicates()
    S.sort_indices()
    ptr, nbr = S.indptr.tolist(), S.indices.tolist()

    agg = [-1] * n
    na = 0
    # pass 1: aggregates around nodes with fully free strong neighbourhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = nbr[ptr[i]:ptr[i + 1]]
        if all(agg[j] == -1 for j in nbrs):
            agg[i] = na
            for j in nbrs:
                agg[j] = na
            na += 1
    # pass 2: attach leftovers to a neighbouring aggregate
    for i in range(n):
        if agg[i] != -1:
            continue
        for j in nbr[ptr[i]:ptr[i + 1]]:
            if agg[j] != -1:
                agg[i] = agg[j]
                break
        else:
            agg[i] = na
            na += 1
    return np.asarray(agg, dtype=np.int64)


def _rho_estimate(M, iters: int = 15) -> float:
    """ρ(M) by 15 power iterations from a standard normal start of numpy's
    generator of seed 0 (the JAX package's host estimate)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(M.shape[0])
    v /= np.linalg.norm(v)
    rho = 1.0
    for _ in range(iters):
        w = M @ v
        rho = np.linalg.norm(w)
        if rho == 0:
            return 1.0
        v = w / rho
    return float(rho)


def amg(A, theta: float = 0.08, omega: float = 0.8, nu: int = 2,
        coarse_size: int = 200, max_levels: int = 12, dtype=None,
        grid: Optional[Tuple[int, int]] = None, box: int = 3,
        setup: str = "auto", *, device=None) -> AMG:
    """Build a smoothed-aggregation hierarchy, as the JAX package's ``amg``.

    ``A`` is a device ``DIA``/``Stencil`` operator (the structured device
    setup, which needs ``grid=``), or a host scipy matrix, whose hierarchy
    lands on ``device`` (required for it).  ``grid=(C1, C2)`` (rows·cols
    == n, symmetric A) aggregates by ``box``×``box`` grid boxes and ships
    the transfers in gather-free structured form; without it the greedy
    host setup aggregates the strength graph (``theta``) and ships ELL
    transfers.  ``setup``: 'device' (the structured setup on ``device``;
    needs ``grid``), 'host' (the scipy setup: box transfers with ``grid``,
    greedy without) or 'auto' (device with ``grid``, greedy without; where
    the structured setup refuses, a warning and the greedy setup, as the
    JAX package falls back).  The hierarchy's dtype defaults to f64."""
    if isinstance(A, (DIA, Stencil)):
        A_dia = as_dia(A)
        if grid is None or setup == "host":
            raise ValueError(
                "device-operator input requires grid= and setup!='host' "
                "(the host path needs a scipy matrix)")
        if dtype is not None and A_dia.dtype != dtype:
            A_dia = dataclasses.replace(A_dia, data=A_dia.data.to(dtype))
        return _amg_device(A_dia, grid, box=box, omega=omega, nu=nu,
                           coarse_size=coarse_size, max_levels=max_levels)
    if isinstance(A, ELL):
        raise ValueError(
            "an ELL operator: the host setup takes its scipy matrix (a "
            "system's A_csr)")
    if device is None:
        raise ValueError("a scipy matrix input needs device=")
    dtype = dtype or DEFAULT_DTYPE
    if grid is not None and setup in ("auto", "device"):
        A_dia = dia_from_scipy(A, wrap=False, dtype=dtype, device=device)
        try:
            return _amg_device(A_dia, grid, box=box, omega=omega, nu=nu,
                               coarse_size=coarse_size, max_levels=max_levels)
        except _StructuredSetupError as e:
            if setup == "device":
                raise
            warnings.warn(f"device AMG setup unavailable ({e}); "
                          "falling back to host GREEDY setup")
            # greedy, not host-structured: what made the structured setup
            # refuse (asymmetry, a stencil that is not grid-local) breaks
            # the host box transfers' assumptions the same way
            grid = None
    return _amg_host(A, theta=theta, omega=omega, nu=nu,
                     coarse_size=coarse_size, max_levels=max_levels,
                     dtype=dtype, grid=grid, box=box, device=device)


def _amg_host(A_csr, theta: float, omega: float, nu: int, coarse_size: int,
              max_levels: int, dtype: torch.dtype,
              grid: Optional[Tuple[int, int]], box: int, device) -> AMG:
    """The JAX package's host setup (``amg.py:243-313`` there): greedy
    aggregation (box aggregation with ``grid``), the smoothed prolongator
    P = (I − ω_s D⁻¹A) P0 with ω_s = (2/3)/ρ(D⁻¹A), R = Pᵀ and the Galerkin
    operator R·A·P by scipy SpGEMM, level by level in f64 on the host; each
    level on ``device`` in ``dtype``: A through ``from_scipy``, P and R as
    ELL (box transfers from the scipy smoothers with ``grid``), and the
    coarsest level's dense inverse."""
    import scipy.sparse as sp

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    levels: List[_Level] = []
    A = sp.csr_matrix(A_csr, dtype=np.float64)
    if grid is not None and int(grid[0]) * int(grid[1]) != A.shape[0]:
        raise ValueError(f"grid {grid} does not tile {A.shape[0]} rows")

    while A.shape[0] > coarse_size and len(levels) < max_levels:
        n = A.shape[0]
        structured = (
            grid is not None and grid[0] >= 2 * box and grid[1] >= 2 * box
        )
        if structured:
            C1, C2 = int(grid[0]), int(grid[1])
            Cc1, Cc2 = -(-C1 // box), -(-C2 // box)
            idx = np.arange(n)
            i, j = idx // C2, idx % C2
            agg = (i // box) * Cc2 + (j // box)
            na = Cc1 * Cc2
        else:
            agg = _aggregate(A, theta)
            na = int(agg.max()) + 1
            if na >= n:  # aggregation stalled
                break
        P0 = sp.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, na),
        )
        dinv = 1.0 / A.diagonal()
        # smoothed prolongator P = (I − ω_s D⁻¹A) P0 with ω_s = 2/3 / ρ̂
        DinvA = sp.diags(dinv) @ A
        rho = _rho_estimate(DinvA)
        SP = sp.csr_matrix(sp.identity(n) - (2.0 / 3.0 / rho) * DinvA)
        P = sp.csr_matrix(SP @ P0)
        R = sp.csr_matrix(P.T)
        if structured:
            # box transfers: a smoother and the reshape aggregation; for
            # symmetric A the transpose smoother is I − ω_s A D⁻¹
            SR = sp.csr_matrix(sp.identity(n) - (2.0 / 3.0 / rho)
                               * (A @ sp.diags(dinv)))
            P_dev = BoxProlong(S=from_scipy(SP, dtype=dtype, device=device),
                               C1=C1, C2=C2, b=int(box), Cc1=Cc1, Cc2=Cc2)
            R_dev = BoxRestrict(S=from_scipy(SR, dtype=dtype, device=device),
                                C1=C1, C2=C2, b=int(box), Cc1=Cc1, Cc2=Cc2)
        else:
            P_dev = ell_from_scipy(P, dtype=dtype, device=device)
            R_dev = ell_from_scipy(R, dtype=dtype, device=device)
        levels.append(_Level(A=from_scipy(A, dtype=dtype, device=device),
                             P=P_dev, R=R_dev, dinv=dev(dinv),
                             omega=float(omega)))
        A = sp.csr_matrix(R @ A @ P)  # Galerkin coarse operator (SpGEMM)
        grid = (Cc1, Cc2) if structured else None

    levels.append(_Level(A=from_scipy(A, dtype=dtype, device=device), P=None,
                         R=None, dinv=dev(1.0 / A.diagonal()),
                         omega=float(omega)))
    return AMG(levels=tuple(levels), coarse_inv=dev(np.linalg.inv(A.toarray())),
               nu=int(nu))


def _grid_decompose(offsets, C2: int, rmax: int = 4):
    """Decompose flat DIA offsets into grid displacements (di, dj) with
    ``off == di*C2 + dj`` and |di|, |dj| ≤ rmax; None if any offset fails.
    The decomposition with minimal |dj| is chosen (unique when C2 > 2·rmax)."""
    out = []
    for off in offsets:
        best = None
        for di in range(-rmax, rmax + 1):
            dj = off - di * C2
            if abs(dj) <= rmax and (best is None or abs(dj) < abs(best[1])):
                best = (di, dj)
        if best is None:
            return None
        out.append(best)
    return out


class _LevelMeta(NamedTuple):
    C1: int
    C2: int
    Cc1: int
    Cc2: int
    offsets: tuple
    rc: int
    p: int
    coffs2d: tuple
    main: int


def _shift_last(X: torch.Tensor, off: int) -> torch.Tensor:
    """Row-aligned zero-fill read along the last axis: out[..., i] =
    X[..., i + off]."""
    n = X.shape[-1]
    if off == 0:
        return X
    if off > 0:
        return F.pad(X[..., off:], (0, min(off, n)))
    return F.pad(X[..., : max(n + off, 0)], (min(-off, n), 0))


def _mv_b(data: torch.Tensor, offs, X: torch.Tensor) -> torch.Tensor:
    """The DIA product of a batch of probes, X of shape (t, n)."""
    Y = torch.zeros_like(X)
    for d, off in enumerate(offs):
        Y = Y + data[d][None, :] * _shift_last(X, off)
    return Y


def _level_setup(mt: _LevelMeta, A: DIA, box: int, rho_iters: int):
    """One level of the setup, on the level's operator A (a non-wrapping DIA,
    whose products go through the DIA kernel on the card with A's live plan,
    built once): the smoother bands, the probed coarse operator as a DIA,
    and the level's asymmetry and probe errors (device scalars)."""
    offs = mt.offsets
    data = A.data
    nlev = mt.C1 * mt.C2
    p = mt.p
    dt, dev = data.dtype, data.device
    dinv = 1.0 / data[mt.main]
    # symmetry check (the structured restriction Sᵣ = I−ω_s A D⁻¹ equals the
    # Galerkin Pᵀ only for symmetric A)
    pos = {o: i for i, o in enumerate(offs)}
    scale = data.abs().max()
    sym_err = torch.zeros((), dtype=dt, device=dev)
    for o in offs:
        if o > 0:
            upper = data[pos[o]]
            lower = (shift(data[pos[-o]], o, False) if -o in pos
                     else torch.zeros_like(upper))
            sym_err = torch.maximum(sym_err, (upper - lower).abs().max() / scale)
    # ρ(D⁻¹A) by power iteration: deterministic pseudo-random start, max of
    # the last 3 norm ratios with a 2% safety margin
    v = torch.sin(torch.arange(nlev, dtype=dt, device=dev) * 12.9898) + 0.01
    v = v / torch.linalg.norm(v)
    for _ in range(rho_iters - 3):
        w = dinv * (A @ v)
        v = w / torch.linalg.norm(w)
    rho = torch.zeros((), dtype=dt, device=dev)
    for _ in range(3):
        w = dinv * (A @ v)
        nw = torch.linalg.norm(w)
        rho = torch.maximum(rho, nw)
        v = w / nw
    rho = rho * 1.02
    cS = (2.0 / 3.0) / rho
    eye = [1.0 if off == 0 else 0.0 for off in offs]
    SP = torch.stack([eye[d] - cS * dinv * data[d] for d in range(len(offs))])
    SR = torch.stack([eye[d] - cS * data[d] * shift(dinv, off, False)
                      for d, off in enumerate(offs)])
    C1, C2, Cc1, Cc2 = mt.C1, mt.C2, mt.Cc1, mt.Cc2
    nc = Cc1 * Cc2

    def apply_RAP(Erows):
        # batched BoxProlong: coarse (t, nc) → fine (t, nlev)
        t = Erows.shape[0]
        Ecg = Erows.reshape(t, Cc1, Cc2)
        Fg = torch.zeros((t, box * Cc1, box * Cc2), dtype=dt, device=dev)
        for ra in range(box):
            for rb in range(box):
                Fg[:, ra::box, rb::box] = Ecg
        Fg = Fg[:, :C1, :C2].reshape(t, nlev)
        Fg = _mv_b(SP, offs, Fg)  # S·(P0 e)
        Fg = _mv_b(data, offs, Fg)  # A·
        # batched BoxRestrict: Sᵣ then pad + strided box sum
        W = _mv_b(SR, offs, Fg).reshape(t, C1, C2)
        W = F.pad(W, (0, box * Cc2 - C2, 0, box * Cc1 - C1))
        Wc = torch.zeros((t, Cc1, Cc2), dtype=dt, device=dev)
        for ra in range(box):
            for rb in range(box):
                Wc = Wc + W[:, ra::box, rb::box]
        return Wc

    # colouring probes → coarse DIA bands: colour (i mod p, j mod p) appears
    # exactly once in any stencil window, so (R∘A∘P) e_colour reads off one
    # band entry per row.  E[(a,c), (i,j)] = 1 iff colour(i,j) == (a,c)
    ic = torch.arange(Cc1, device=dev) % p
    jc = torch.arange(Cc2, device=dev) % p
    pa = torch.arange(p, device=dev)
    E = ((ic[None, None, :, None] == pa[:, None, None, None])
         & (jc[None, None, None, :] == pa[None, :, None, None]))
    Y = apply_RAP(E.to(dt).reshape(p * p, nc))  # (p², Cc1, Cc2)
    ii = torch.arange(Cc1, device=dev)[:, None]
    jj = torch.arange(Cc2, device=dev)[None, :]
    bands = []
    for (di, dj) in mt.coffs2d:
        # the probe of the (i+di, j+dj) neighbour's colour
        sel = ((ii + di) % p) * p + ((jj + dj) % p)
        bands.append(Y[sel, ii, jj].reshape(-1))
    coarse = DIA(torch.stack(bands),
                 tuple(di * Cc2 + dj for di, dj in mt.coffs2d), (nc, nc),
                 False)
    # a-posteriori radius check: the extracted stencil must act like the
    # composed operator on a generic vector
    wtest = torch.sin(torch.arange(nc, dtype=dt, device=dev) * 7.13) + 0.3
    y_true = apply_RAP(wtest[None, :]).reshape(-1)
    y_band = coarse @ wtest
    probe_err = ((y_true - y_band).abs().max()
                 / torch.clamp(y_true.abs().max(), min=1e-30))
    return dinv, SP, SR, coarse, sym_err, probe_err


def _amg_device(A_dia: DIA, grid: Tuple[int, int], box: int = 3,
                omega: float = 0.8, nu: int = 2, coarse_size: int = 200,
                max_levels: int = 12, rho_iters: int = 25) -> AMG:
    """Structured-grid SA hierarchy built on the operator's device.

    For a grid-local stencil operator (every DIA offset = di·C2+dj with
    small |di|, |dj|) aggregated over box×box grid boxes, the Galerkin
    coarse operator R·A·P is itself a grid-local stencil of radius
    rc = ⌊(box−1+3r)/box⌋, so its DIA bands are recovered exactly by
    (2rc+1)²-colouring probes.  Per-level probe residuals on a generic
    vector verify the radius assumption a posteriori.
    """
    if A_dia.wrap:
        raise _StructuredSetupError("periodic (wrapping) DIA not supported")
    C1, C2 = int(grid[0]), int(grid[1])
    n0 = A_dia.shape[0]
    if C1 * C2 != n0:
        raise _StructuredSetupError(f"grid {grid} does not tile {n0} rows")

    # --- static level schedule (host) -----------------------------------
    metas = []
    offsets = tuple(A_dia.offsets)
    c1, c2, n = C1, C2, n0
    while n > coarse_size and min(c1, c2) >= 2 * box and len(metas) < max_levels:
        dec = _grid_decompose(offsets, c2)
        if dec is None:
            if not metas:
                raise _StructuredSetupError(
                    f"offsets {offsets} are not grid-local on {c1}×{c2}")
            break
        if 0 not in offsets:
            raise _StructuredSetupError("operator has no main diagonal")
        r = max(max(abs(di), abs(dj)) for di, dj in dec)
        rc = (box - 1 + 3 * r) // box
        p = 2 * rc + 1
        cc1, cc2 = -(-c1 // box), -(-c2 // box)
        coffs2d = tuple((di, dj) for di in range(-rc, rc + 1)
                        for dj in range(-rc, rc + 1))
        metas.append(_LevelMeta(
            C1=c1, C2=c2, Cc1=cc1, Cc2=cc2, offsets=offsets, rc=rc, p=p,
            coffs2d=coffs2d, main=offsets.index(0),
        ))
        offsets = tuple(di * cc2 + dj for di, dj in coffs2d)
        c1, c2, n = cc1, cc2, cc1 * cc2
    if not metas:
        raise _StructuredSetupError(
            f"grid {grid} too small to coarsen (box={box})")
    coarse_offsets = offsets

    # --- the levels, then the dense coarsest inverse (device) -------------
    coarse = A_dia
    shipped, sym_errs, probe_errs = [], [], []
    for mt in metas:
        fine = coarse
        dinv, SP, SR, coarse, sym_err, probe_err = _level_setup(
            mt, fine, box, rho_iters)
        shipped.append((fine, dinv, SP, SR))
        sym_errs.append(sym_err)
        probe_errs.append(probe_err)
    data = coarse.data
    nC = data.shape[1]
    rows = torch.arange(nC, device=data.device)
    dense = torch.zeros((nC, nC), dtype=data.dtype, device=data.device)
    for d, off in enumerate(coarse_offsets):
        cols = rows + off
        valid = (cols >= 0) & (cols < nC)
        dense.index_put_((rows, cols.clamp(0, nC - 1)),
                         torch.where(valid, data[d], 0.0), accumulate=True)
    cinv = torch.linalg.inv(dense)
    dinv_c = 1.0 / data[coarse_offsets.index(0)]

    eps = torch.finfo(A_dia.dtype).eps
    se = float(torch.stack(sym_errs).max())
    if se > 1e3 * eps:
        raise _StructuredSetupError(
            f"operator is not symmetric (rel asymmetry {se:.2e}); the "
            "structured transfers assume A = Aᵀ")
    for lvl, pe in enumerate(torch.stack(probe_errs).tolist()):
        if pe > 1e4 * eps:
            raise _StructuredSetupError(
                f"probed coarse stencil at level {lvl + 1} does not "
                f"reproduce R·A·P (rel err {pe:.2e}) — the Galerkin "
                "operator is not grid-local at the assumed radius")

    levels: List[_Level] = []
    for mt, (fine, dinv, SP, SR) in zip(metas, shipped):
        offs = mt.offsets
        shape = (mt.C1 * mt.C2,) * 2
        levels.append(_Level(
            A=fine,
            P=BoxProlong(S=DIA(SP, offs, shape, False), C1=mt.C1, C2=mt.C2,
                         b=box, Cc1=mt.Cc1, Cc2=mt.Cc2),
            R=BoxRestrict(S=DIA(SR, offs, shape, False), C1=mt.C1, C2=mt.C2,
                          b=box, Cc1=mt.Cc1, Cc2=mt.Cc2),
            dinv=dinv,
            omega=float(omega),
        ))
    levels.append(_Level(
        A=coarse, P=None, R=None, dinv=dinv_c, omega=float(omega),
    ))
    return AMG(levels=tuple(levels), coarse_inv=cinv, nu=int(nu))
