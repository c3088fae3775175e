"""Preconditioned conjugate gradients (SPD systems).

The port of the JAX package's ``solvers/cg.py``.  The reference ships no CG
(its systems are mildly nonsymmetric); the JAX package adds it for the SPD
paths (the heat operator M/dt + ½K is SPD).  ``loop="host"`` (the default)
runs the iteration on the host, the vectors and the scalars of the
recurrence on the operands' device: each step reads only its residual norm
on the host.  ``loop="while"`` runs it on a device core (``CgCore``), the
counterpart of the JAX package's ``_build_core`` (one ``lax.while_loop``
there): three fixed-shape steps on static buffers, each a CUDA graph on the
card, and one read of the flags after each step.

Every inner product and norm is taken over the mesh of a row-sharded
operator (``parallel/comm.py::pdot``, ``pnorm`` over ``mesh_of(A)``), as
GSPMD takes global dots in the JAX package; without a mesh they are
``torch.dot`` and ``torch.linalg.norm``.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import check_storage
from ..parallel.comm import mesh_of, pdot, pnorm, psum
from ..precond.base import as_preconditioner
from .graphs import GraphRunner
from .gmres import as_operand


def cg(A, b: torch.Tensor, x0=None, k: int = 100, tol: float = 1e-8,
       pre=None, loop: str = "host"):
    """Solve SPD ``A x = b``; returns ``(x, info)`` on the common contract:
    ``info`` holds ``name='cg'``, the per-iteration residuals ``res`` and
    ``steps``.

    The residuals follow the CG recurrence (r is b − A x up to roundoff);
    the last entry is replaced by the recomputed true residual, as the JAX
    package does, without an extra product per iteration.  ``loop``:
    ``"host"`` or ``"while"`` (the device core, ``CgCore``; the last
    ``CORE_CACHE`` cores are kept, on A, the preconditioner, ``k``, the
    dtype and the device, so one core serves every b, x0 and tol)."""
    check_storage(b)
    x0 = as_operand(x0, b)
    if loop == "while":
        return _run_device(A, b, x0, k, tol, pre)
    if loop != "host":
        raise ValueError(f"loop={loop!r}: use 'host' or 'while'")
    mesh = mesh_of(A)
    x = torch.zeros_like(b) if x0 is None else x0
    prefunc = as_preconditioner(pre)
    r = b - A @ x
    z = prefunc(r)
    p = z
    rz = pdot(r, z, mesh)
    res = np.full(k, np.inf)
    j, done = 0, float(pnorm(r, mesh)) < tol
    while j < k and not done:
        Ap = A @ p
        alpha = rz / pdot(p, Ap, mesh)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prefunc(r)
        rz_new = pdot(r, z, mesh)
        p = z + (rz_new / rz) * p
        rz = rz_new
        res[j] = float(pnorm(r, mesh))
        done = res[j] < tol
        j += 1
    res[max(j - 1, 0)] = float(pnorm(A @ x - b, mesh))
    return x, {"name": "cg", "res": res[: max(j, 1)], "steps": j}


# --- the device core -----------------------------------------------------------


class CgCore:
    """CG as fixed-shape steps on the operands' device: the JAX package's
    ``_build_core`` (``solvers/cg.py:33-77`` there).

    Its static buffers are the inputs ``b``, ``x0`` and ``tol`` (a device
    scalar, f64: one core serves every tolerance), the recurrence's ``x``,
    ``r``, ``p`` and ``rz`` (the JAX carry's z is not read after its step),
    the residual trace ``res`` (k, inf before a step writes it), the step
    count ``j``, ``done`` and ``flags`` ([done, j], the host's one read a
    step).  Its ``runner`` (``GraphRunner``) runs three steps, each reading
    and writing only those (captured and replayed on the card, eagerly on
    the CPU):

    * ``cg_init``: r0 = b − A x0, z0 = pre(r0), p = z0, rz = r0·z0, x = x0,
      and done = ‖r0‖ < tol;
    * ``cg_step``: one CG iteration, every write masked by ``~done`` (the
      JAX ``body``), its residual norm into ``res[j]``, j + 1, done;
    * ``cg_finish``: the true residual ‖A x − b‖ into ``res[max(j − 1, 0)]``.

    ``solve`` replays ``cg_step`` until the flags say done or j = k.  No
    scalar of the recurrence leaves the device: alpha and beta are 0-d
    tensors, and a masked step divides by 1 where its denominators would
    be those of a converged recurrence (0/0 would put a NaN into the
    masked branch of ``torch.where``)."""

    def __init__(self, A, pre, k: int, *, like: torch.Tensor):
        check_storage(like)
        self.A, self.pre, self.prefunc = A, pre, as_preconditioner(pre)
        self.mesh = mesh_of(A)
        self.k = int(k)
        self.runner = GraphRunner(like.device)
        n, dt, dev = like.shape[0], like.dtype, like.device

        def z(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.b, self.x0, self.x, self.r, self.p = (z(n) for _ in range(5))
        self.rz, self.res = z(), z(self.k)
        self.tol = z(dtype=torch.float64)
        self.j = z(dtype=torch.long)
        self.done = z(dtype=torch.bool)
        self.flags = z(2, dtype=torch.long)
        self.index = torch.arange(self.k, device=dev)
        self.runner.warmup(self._first_use)

    def _first_use(self):
        """What the steps do the first time they meet the card, on scratch
        tensors: under a mesh first one all-reduce (a communicator is not
        created inside a capture), then the kernel builds and loads, each
        DIA's live plan and resolved launch (the AMG's levels among them:
        one preconditioner apply) and the reductions' handles."""
        v = torch.ones_like(self.b)
        psum(v.new_ones(1), self.mesh)
        w = self.prefunc(self.A @ v)
        pnorm(w - v, self.mesh)
        pdot(v, w, self.mesh)

    def load(self, b: torch.Tensor, x0, tol: float) -> None:
        """Copy a solve's inputs into the static buffers: b, x0 (None: zero)
        and tol."""
        self.b.copy_(b)
        if x0 is None:
            self.x0.zero_()
        else:
            self.x0.copy_(x0)
        self.tol.fill_(float(tol))

    def solve(self) -> int:
        """Run the loaded solve; returns its steps.  The results stay in the
        static buffers (``x``, ``res``)."""
        R = self.runner
        R.run("cg_init", self._init)
        done, j = R.read(self.flags)
        while j < self.k and not done:
            R.run("cg_step", self._step)
            done, j = R.read(self.flags)
        R.run("cg_finish", self._finish)
        return j

    # --- the steps -------------------------------------------------------------

    def _set_flags(self) -> None:
        self.flags.copy_(torch.stack([self.done.long(), self.j]))

    def _init(self) -> None:
        r = self.b - self.A @ self.x0
        z = self.prefunc(r)
        self.x.copy_(self.x0)
        self.r.copy_(r)
        self.p.copy_(z)
        self.rz.copy_(pdot(r, z, self.mesh))
        self.res.fill_(float("inf"))
        self.j.zero_()
        self.done.copy_(pnorm(r, self.mesh).double() < self.tol)
        self._set_flags()

    def _step(self) -> None:
        live = ~self.done
        Ap = self.A @ self.p
        alpha = self.rz / torch.where(live, pdot(self.p, Ap, self.mesh), 1.0)
        x = self.x + alpha * self.p
        r = self.r - alpha * Ap
        z = self.prefunc(r)
        rz_new = pdot(r, z, self.mesh)
        p = z + (rz_new / torch.where(live, self.rz, 1.0)) * self.p
        rnorm = pnorm(r, self.mesh)
        for buf, new in ((self.x, x), (self.r, r), (self.p, p),
                         (self.rz, rz_new)):
            buf.copy_(torch.where(live, new, buf))
        self.res.copy_(torch.where(live & (self.index == self.j), rnorm,
                                   self.res))
        self.j.add_(live.long())
        self.done.copy_(self.done | (rnorm.double() < self.tol))
        self._set_flags()

    def _finish(self) -> None:
        true = pnorm(self.A @ self.x - self.b, self.mesh)
        last = (self.j - 1).clamp(min=0)
        self.res.copy_(torch.where(self.index == last, true, self.res))


# the CG cores of the last ``CORE_CACHE`` keys that ``cg(loop="while")``
# ran, with their captured graphs, the most recent last
CORE_CACHE = 2
_CORES: "collections.OrderedDict" = collections.OrderedDict()


def last_core() -> CgCore:
    """The device core of the last ``cg(loop="while")`` solve."""
    return next(reversed(_CORES.values()))


def _core_for(A, b, k, pre) -> CgCore:
    """The cached CG core for A, the preconditioner, k, b's dtype and
    device, built (dropping the oldest past ``CORE_CACHE``) if none is."""
    from .cgmres import _key

    key = (_key(A), _key(pre), int(k), b.dtype, str(b.device))
    core = _CORES.get(key)
    if core is None:
        while len(_CORES) >= CORE_CACHE:
            _CORES.popitem(last=False)
        core = _CORES[key] = CgCore(A, pre, k, like=b)
    _CORES.move_to_end(key)
    return core


def _run_device(A, b, x0, k, tol, pre):
    core = _core_for(A, b, k, pre)
    core.load(b, x0, tol)
    steps = core.solve()
    res = core.res.cpu().numpy().astype(np.float64)
    return core.x.clone(), {"name": "cg", "res": res[: max(steps, 1)],
                            "steps": steps}
