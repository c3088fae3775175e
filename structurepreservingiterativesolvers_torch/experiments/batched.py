"""Batched solves on the device: many right-hand sides, one operator.

The port of the JAX package's ``experiments/batched.py``.  When the operator
is shared and only the right-hand side, the initial guess and the
constraints' targets vary (time-step batches, an ensemble of perturbed
initial states, tolerance studies), the whole batch runs as one device
program.  The JAX package ``vmap``s its CGMRES core; here the device core
has a leading batch axis (``solvers/cgmres.py::DeviceCore``), each step a
CUDA graph on the card, and every product of a DIA A with the batch goes
through the batched kernel #1 (``csrc/dia_spmm.cu``), the counterpart of
the JAX package's ``dia_spmv_pallas`` under ``vmap``.

The batched core takes what the JAX package's vmapped core takes: quadratic
constraints (the JAX ``cgmres_many`` builds its core with ``kinds``
``("q",) * m``, so a general constraint raises there too), the plain CGS2,
and no preconditioner or one that applies to a block (n, B) column by
column: the skew-normal Chebyshev (swe's, a chain of ``A @ X``), the
structured AMG (its V-cycle on the block, every level's product one launch
of #1b), the Chebyshev and Neumann polynomials (one launch of the block
forms #3b and #4b when fused, the recurrences over ``A @ X`` otherwise),
Jacobi, lkdvRK's ``BlockJacobi`` and ``RAS`` (a gather, one ``torch.bmm``
of the block inverses with the B vectors, a scatter) and the RAS + Neumann
composite (``NeumannComposite``, its ``A @ Z`` through #1b on a DIA, the
ELL's block product otherwise).  On heat ``A @ X`` is one launch of the
stencil kernel's block form #2b.  Any other preconditioner raises; none
runs item by item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CTOL, check_storage
from ..constraints.general import GeneralConstraint
from ..constraints.quadratic import QuadraticConstraint
from ..precond.amg import AMG
from ..precond.chebyshev import (
    Chebyshev,
    Neumann,
    NeumannComposite,
    SkewNormalChebyshev,
)
from ..precond.jacobi import RAS, BlockJacobi, Jacobi
from ..solvers.cgmres import _core_for, resolve_modes
from ..utils.profiling import span

# the preconditioners the batched core takes: each applies to a block (a
# NeumannComposite where its inner one does)
_TAKEN = (SkewNormalChebyshev, AMG, Chebyshev, Neumann, Jacobi, BlockJacobi,
          RAS, NeumannComposite)


def _same(a, b) -> bool:
    """a and b are equal by value: the same object, tensors of one shape,
    dtype and device with equal entries, dataclasses of one type with equal
    compared fields, sequences of equal items, or equal plain values."""
    if a is b:
        return True
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype
                and a.device == b.device and bool(torch.equal(a, b)))
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a) if f.compare)
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def batch_constraints(cons_list: Sequence) -> Tuple[tuple, tuple]:
    """Merge the items' constraint lists into one batched list, and the
    batch axis of each field (the JAX package's ``batch_constraints``,
    ``batched.py:23-51`` there, with its ``in_axes``).

    A field equal across the items, compared by value, is shared (axis
    None); a field that varies is stacked on a new leading axis (axis 0).
    The core is built for one set of operators, so a constraint's M must be
    shared: a varying M raises ``ValueError``.  Returns ``(batched, axes)``,
    each a tuple of ``QuadraticConstraint``s, ``axes`` holding None or 0 in
    place of v and c (and None for M)."""
    items = [tuple(c) for c in cons_list]
    if not items:
        return (), ()
    m = len(items[0])
    if any(len(c) != m for c in items):
        raise ValueError("the items have different numbers of constraints")
    batched, axes = [], []
    for i in range(m):
        col = [c[i] for c in items]
        if any(isinstance(c, GeneralConstraint) for c in col):
            raise NotImplementedError(
                "a general constraint under a batch: the JAX package's "
                "cgmres_many builds its core for quadratic constraints only "
                "(kinds ('q',) * m), so it refuses one too; solve each item "
                "with cgmres(loop='while')")
        fields, ax = {}, {}
        for name in ("M", "v", "c"):
            vals = [getattr(c, name) for c in col]
            if all(_same(v, vals[0]) for v in vals[1:]):
                fields[name], ax[name] = vals[0], None
            elif name == "M":
                raise ValueError(
                    f"constraint {col[0].name!r}: its operator M differs "
                    "across the items; the batched core is built for one "
                    "set of operators")
            elif any(v is None for v in vals):
                raise ValueError(f"constraint {col[0].name!r}: {name} is None "
                                 "for some items and not for others")
            else:
                fields[name], ax[name] = torch.stack(vals), 0
        batched.append(QuadraticConstraint(name=col[0].name, **fields))
        axes.append(QuadraticConstraint(M=None, v=ax["v"], c=ax["c"],
                                        name=col[0].name))
    return tuple(batched), tuple(axes)


def _check_pre(pre) -> None:
    if isinstance(pre, NeumannComposite):
        return _check_pre(pre.inner)
    if pre is None or isinstance(pre, _TAKEN):
        return
    raise NotImplementedError(
        f"preconditioner {type(pre).__name__}: the batched core takes "
        "pre=None or " + ", ".join(c.__name__ for c in _TAKEN))


def cgmres_many(
    A,
    Bs: torch.Tensor,  # (batch, n) right-hand sides
    constraints_list: Sequence[Sequence] = (),  # per-item constraint lists
    X0s: Optional[torch.Tensor] = None,
    k: int = 30,
    tol: float = 1e-8,
    contol: float = 10.0,
    ctol: float = CTOL,
    pre=None,
    mixed: Optional[bool] = None,
):
    """Solve A x_i = b_i for a batch of right-hand sides with per-item
    constraint targets, as one device program: the batched device core,
    each step a CUDA graph on the card (eager on the CPU), on the device of
    ``Bs``, in its dtype: f64, or f32 storage with ``mixed`` (default: f32
    storage) the constraint and KKT state in f64 and the in-loop reduction
    in f64, without the projection, as the JAX package's ``cgmres_many``
    builds its core (``batched.py:64-84`` there).  Returns ``(Xs, info)``:
    Xs (B, n) on the device, and
    ``steps``, ``deviation``, ``safety`` (0 none, 1 certified, 2 tripped)
    and ``res`` (B, k; inf beyond a solve's steps) as numpy arrays, fetched
    in one device-to-host copy.  The last batched core is kept, as
    ``cgmres(loop="while")`` keeps its core, so a second call with new
    right-hand sides or targets replays the first one's graphs."""
    check_storage(Bs)
    if Bs.dim() != 2:
        raise ValueError(f"Bs is (batch, n), got {tuple(Bs.shape)}")
    _check_pre(pre)
    if X0s is not None:
        X0s = torch.as_tensor(X0s, dtype=Bs.dtype, device=Bs.device)
    cons, _ = batch_constraints(list(constraints_list))
    mixed, _, _ = resolve_modes(Bs.dtype, cons, mixed, snap=False,
                                f32_reduce=False)
    core = _core_for(A, Bs, X0s, k, tol, contol, cons, pre, ctol, "cgs2",
                     modes=(mixed, False, False))
    core.load(Bs, X0s, cons)
    with span("cgmres_many", Bs.device):
        core.solve()
    out = core.result()
    res = out.res.double()
    host = torch.cat([out.steps.double()[:, None], out.deviation[:, None],
                      out.safety.double()[:, None], res], dim=1).cpu().numpy()
    return out.x, {
        "steps": host[:, 0].astype(np.int64),
        "deviation": host[:, 1],
        "safety": host[:, 2].astype(np.int64),
        "res": host[:, 3:],
    }
