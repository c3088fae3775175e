"""Discrete invariant projection: snap an assembled f32 iterate onto the
constraint manifold.

The port of the JAX package's ``constraints/projection.py``.  With f32
storage the CGMRES endgame enforces the *reduced* constraints
``g(y) = t0 + t1·y + yᵀT2y`` to ~1e-12 in f64 coefficient space, but the
returned iterate is the f32 assembly ``x = x0 + Zᵀy``, whose rounding alone
re-introduces deviations of about ``√n·eps32·rms(∂g/∂x_i · x_i)``: 1e-4 to
1e-3 absolute on swe's energy (e0 ≈ 2.9e4).  The projection measures the
true deviations at the assembled x in f64 (``value_f64``: f32 loads, f64
products and sums, where the JAX package computes in double-f32 pairs) and
moves x onto the manifold:

1. dense Newton stages: the least-norm step x ← x − Dᵀ(DDᵀ)⁻¹ g with D the
   constraint Jacobian, damped by a backtracking τ, and rounded to f32
   without bias (``_dithered``): on a large vector the step is a fraction
   of an ulp a component, which a rounding to nearest drops (heat P2 at
   n ≈ 10^6 stalled near 5e-9 so, its trim windows' rough steps raising
   the energy through the stiffness);
2. windowed trim stages: the same step restricted to a small window of
   components, whose re-rounding noise scales as √window instead of √n.

Every stage is guarded: the candidate's deviations are evaluated through
the exact quadratic increment and kept only if the worst one decreased
(``torch.where``, no data-dependent control flow).  Two rounds run, each
ending in a fresh f64 evaluation: the next round's entry and, after the
last, the certificate at the returned iterate.

On the card the whole projection is one CUDA graph (the device core's
``snap`` step): the window start is an argmax on the device and its mask a
comparison, the accept guard a ``torch.where``, the backtracking τ an
argmin on the device; nothing is read on the host.  The JAX package keeps
its τ grid as a module-level array (``_TAUS``), which leaks a tracer when
the module is first imported inside a trace; here it is built per call.

On row-sharded data (the constraints' ``mesh``) x, D and the directions
are each rank's rows: every n-length f64 reduction of a stage (its dots,
the Gram matrix) is one all-reduce (``parallel/comm.py::psum``), the
evaluations all-reduce their terms (``value_and_scale_f64``), the trim
window is picked once over the global vector (``_window_mask``: the chunk
scores all-reduced, so every rank trims the same components), and the
certificate's trim bound takes the global maximum (``pmax``).  Every
accept guard and τ then derives from all-reduced values, alike on every
rank.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.sparse import f64_supported
from ..parallel.comm import mesh_of, pmax, psum
from .quadratic import QuadraticConstraint, value_and_scale_f64, value_f64

# Shrinking-window ladder of the JAX package (measured there, swe M=64..256
# f32): two dense stages (0) remove any above-roundoff deviation; each
# narrower window then concentrates the correction in fewer components
# (per-component update ≫ ulp) while its re-rounding noise shrinks as √w.
_LADDER = (0, 0, 0, 0, 0, 0, 2048, 512, 128, 32, 8)

# the backtracking grid of a dense stage: 1, 1/2, …, 2^-12
_NTAUS = 13


def snap_supported(cons: Sequence) -> bool:
    """Every constraint is quadratic with an operator ``matvec_f64`` takes
    (the JAX package's ``snap_supported``)."""
    return all(isinstance(c, QuadraticConstraint) and f64_supported(c.M)
               for c in cons)


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b with f32 loads, f64 products and an f64 sum (this rank's rows;
    the caller all-reduces a stage's dots together)."""
    return torch.dot(a.double(), b.double())


def _deviations(cons, x: torch.Tensor) -> torch.Tensor:
    """(m,) f64 true deviations at f32 x."""
    return torch.stack([value_f64(c, x) for c in cons])


def _global(n: int, mesh) -> tuple:
    """The global length of a row-sharded vector of ``n`` local rows, and
    this rank's first row (n and 0 without a mesh)."""
    if mesh is None:
        return n, 0
    n_all = n * mesh.size
    return n_all, mesh.rows(n_all)[0]


def _window_mask(D: torch.Tensor, w: int, mesh=None) -> torch.Tensor:
    """(n,) mask in D's dtype selecting the width-``w`` aligned chunk on
    which every constraint's gradient is strongest (max over chunks of the
    min over constraints of the chunk gradient norm²): a fixed corner
    window can be gradient-degenerate (swe's Gaussian's far corner).
    Under a mesh D holds this rank's columns: the chunks are those of the
    global vector, their scores summed over the ranks (one all-reduce), so
    every rank picks the same chunk and masks its own part of it."""
    m, n = D.shape
    if mesh is None:
        nc = n // w
        scores = (D[:, : nc * w].reshape(m, nc, w) ** 2).sum(-1).amin(0)
        start = scores.argmax() * w
        idx = torch.arange(n, device=D.device)
    else:
        n_all, r0 = _global(n, mesh)
        nc = n_all // w
        idx = torch.arange(r0, r0 + n, device=D.device)
        # the rows past the last whole chunk into a spare bucket
        chunk = torch.clamp(idx // w, max=nc)
        sq = torch.zeros((m, nc + 1), dtype=D.dtype, device=D.device)
        sq.index_add_(1, chunk, D ** 2)
        start = psum(sq, mesh)[:, :nc].amin(0).argmax() * w
    return ((idx >= start) & (idx < start + w)).to(D.dtype)


def _newton_direction(D: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                      window: int = 0, mesh=None) -> torch.Tensor:
    """Least-norm Newton direction −Dᵀ(DDᵀ+λI)⁻¹ g, optionally with D
    restricted to the strongest aligned window of ``window`` components.
    The Gram matrix is formed in f32 and solved in f64 (Newton needs ~1e-3
    relative accuracy in it; the f64 re-evaluation of g certifies); the
    Tikhonov floor, 1e-6 of its trace (about 8·eps32: below the f32 Gram
    matrix's own rounding its eigen-directions are noise), keeps a
    rank-deficient window from a huge step.  (The JAX package's 1e-12 lets
    a window where two gradients are nearly parallel, lkdvRK's momentum and
    energy over a stage's u field, take steps that raise every deviation
    by four orders: the guard then rejects each trim stage, and a
    warm-started lkdvRK M=400 step stalls above its certificate floor.)"""
    from ..solvers.kkt import solve_dense

    if window:
        D = D * _window_mask(D, window, mesh)[None, :]
    G = psum(D @ D.T, mesh).double()
    lam = 1e-6 * torch.clamp(torch.trace(G), min=1e-30)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    alpha = solve_dense(G + lam * eye, -g)
    # the (roundoff-sized) coefficients in x's dtype before the n-sized work
    return alpha.to(x.dtype) @ D


def _dither(n: int, mesh, device) -> torch.Tensor:
    """(n,) f64 thresholds in [0, 1) for this rank's rows: the golden-ratio
    sequence frac((i + 1)·φ⁻¹) of each row's global index i, so that the
    thresholds of neighbouring rows spread evenly over [0, 1)."""
    r0 = _global(n, mesh)[1]
    i = torch.arange(r0 + 1, r0 + n + 1, dtype=torch.float64, device=device)
    return torch.frac(i * 0.6180339887498949)


def _dithered(x: torch.Tensor, step: torch.Tensor,
              dither: torch.Tensor) -> torch.Tensor:
    """x + step (f64) rounded to x's dtype without bias: each component
    goes to the nearest value r or to its neighbour on the far side of
    x + step, the neighbour where the component's threshold is below the
    share of the gap between them that x + step covers.  A step below half
    an ulp then still moves that share of the components by one ulp, so
    the realised step keeps the direction's sums (a nearest rounding drops
    every such component, and a dense stage on a large vector, whose
    per-component step is a tenth of an ulp, moves almost nothing)."""
    t = x.double() + step
    r = t.to(x.dtype)
    e = t - r.double()
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(e > 0, inf, -inf))
    share = e.abs() / (nb.double() - r.double()).abs()
    return torch.where(dither < share, nb, r)


def _increment(cons, D, g, x, x_entry, delta, mesh=None) -> torch.Tensor:
    """The deviations after the realised update ``delta`` through the exact
    quadratic increment  g(x+Δ) = g(x) + ∇g(x)·Δ + ½ΔᵀMΔ  with
    ∇g(x) = D_entry + M(x − x_entry):
    (M(x−x_entry))·Δ + ½Δ·MΔ = (MΔ)·((x − x_entry) + ½Δ); the m
    increments in one all-reduce under a mesh."""
    out = []
    for ci, con in enumerate(cons):
        t = _dot64(D[ci], delta)
        if con.M is not None:
            md = con.M @ delta
            t = t + _dot64(md, (x - x_entry) + 0.5 * delta)
        out.append(t)
    return g + psum(torch.stack(out), mesh)


def snap(x: torch.Tensor, cons: Sequence[QuadraticConstraint],
         windows: Tuple[int, ...] = _LADDER, rounds: int = 2):
    """Project f32 ``x`` onto the constraint manifold; returns
    ``(x_snapped, deviations)``, the deviations the certified f64 values of
    each constraint at the RETURNED iterate (JAX ``projection.py:113-210``).

    Cost: three full f64 evaluations per constraint (at entry, between the
    rounds, and the exit certificate: a mixed kernel #1 each for a DIA M);
    between them every stage re-evaluates through the exact quadratic
    increment (``_increment``): f64 dots and one f32 product with M.  A
    dense stage takes the gradient afresh (m f32 products) and picks its
    damping τ from the increment along τ·direction, exactly quadratic in τ,
    for the whole grid at once."""
    m = len(cons)
    if m == 0:
        return x, torch.zeros(0, dtype=torch.float64, device=x.device)
    mesh = mesh_of(*cons)
    n = _global(x.shape[0], mesh)[0]
    taus = torch.pow(2.0, -torch.arange(_NTAUS, dtype=torch.float64,
                                        device=x.device))
    g = _deviations(cons, x)
    dither = _dither(x.shape[0], mesh, x.device)
    for _ in range(max(int(rounds), 1)):
        D = torch.stack([c.grad(x) for c in cons])  # (m, n) in x's dtype
        x_entry = x
        for window in windows:
            if window >= n:
                continue
            if window == 0:
                # a stale gradient stalls the descent on a strongly curved
                # manifold from a large deviation: refresh it
                D = torch.stack([c.grad(x) for c in cons])
                x_entry = x
            dirn = _newton_direction(D, x, g, window, mesh)
            if window == 0:
                # the damped dense stage: the increment along τ·dirn is
                # exactly quadratic in τ, so the whole grid costs one
                # linear and one quadratic coefficient per constraint
                lin, quad = [], []
                for ci, con in enumerate(cons):
                    lin_c = _dot64(D[ci], dirn)
                    quad_c = torch.zeros((), dtype=torch.float64,
                                         device=x.device)
                    if con.M is not None:
                        md = con.M @ dirn
                        lin_c = lin_c + _dot64(md, x - x_entry)
                        quad_c = 0.5 * _dot64(md, dirn)
                    lin.append(lin_c)
                    quad.append(quad_c)
                # one all-reduce for the stage's 2m dots
                lin, quad = psum(torch.stack(lin + quad), mesh).split(m)
                gmod = (g[None, :] + taus[:, None] * lin[None, :]
                        + (taus ** 2)[:, None] * quad[None, :])
                # the τ of the least worst deviation, picked on the device
                tau = taus.gather(0, gmod.abs().amax(1).argmin().reshape(1))
                x_new = _dithered(x, tau * dirn.double(), dither)
            else:
                x_new = x + dirn
            delta = x_new - x  # the realised (post-rounding) update
            g_new = _increment(cons, D, g, x, x_entry, delta, mesh)
            better = ((g_new.abs().amax() < g.abs().amax())
                      & torch.isfinite(g_new).all())
            x = torch.where(better, x_new, x)
            g = torch.where(better, g_new, g)
        # a fresh f64 evaluation: the next round's entry and the certificate
        g = _deviations(cons, x)
    return x, g


def certified_floor(cons: Sequence[QuadraticConstraint], x: torch.Tensor,
                    ctol: float) -> torch.Tensor:
    """(m,) f64: the deviation to which ``snap`` certifies each constraint
    at the f32 iterate x it returns, the largest of ``ctol``, the f64
    evaluation's roundoff 32·eps64·s (s the sum of the magnitudes of g's
    terms, ``value_and_scale_f64``) and the rounding of a trim stage: a
    stage over a window of w components moves each to a nearest f32, which
    moves g by up to eps32·|x_i ∂g/∂x_i|/2 a component, so by up to
    (w/2)·eps32·max_i |x_i ∂g/∂x_i(x)|, taken at the ladder's second
    narrowest window (w = 32): the guard keeps the narrowest stage (8) only
    where it improves, and with three constraints on a few hundred
    unknowns (lkdv) it can end above its own bound.  An iterate the
    projection did not move keeps the assembly's rounding, the sum of n
    such moves.  No host read (the device core's ``snap`` graph calls
    it)."""
    eps64 = torch.finfo(torch.float64).eps
    eps32 = torch.finfo(torch.float32).eps
    xd = x.double()
    scale, big = [], []
    for c in cons:
        scale.append(value_and_scale_f64(c, x)[1])
        big.append((xd * c.grad(x).double()).abs().amax())
    # the largest |x_i ∂g/∂x_i| over every rank's rows
    trim = 0.5 * _LADDER[-2] * eps32 * pmax(torch.stack(big), mesh_of(*cons))
    return torch.clamp(torch.maximum(32.0 * eps64 * torch.stack(scale), trim),
                       min=ctol)
