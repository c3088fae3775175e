"""The PyTorch port's own assembly of lkdv and swe against the JAX package's:
the operator, the right-hand side, the initial state, the invariant targets
and the invariants of a random vector.  Both assemble in numpy/scipy, so
they agree to rounding (1e-14 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.models import lkdv as tlkdv
from structurepreservingiterativesolvers_torch.models import swe as tswe
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.models import swe as jswe

RTOL = 1e-14

CASES = {
    "lkdv_easy": (jlkdv, tlkdv, torch_parity.LKDV_EASY),
    "lkdv_hard": (jlkdv, tlkdv, torch_parity.LKDV_HARD),
    "swe16": (jswe, tswe, dict(M=16)),
}


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert np.max(np.abs(a - b)) <= RTOL * scale


@pytest.mark.parametrize("name", list(CASES))
def test_assembly_matches_jax(name):
    jmod, tmod, params = CASES[name]
    js, ts = jmod.linforms(**params), tmod.linforms(device="cpu", **params)
    ops = [("A", js.A, ts.A)]
    if name.startswith("lkdv"):
        ops += [("Mmat", js.Mmat, ts.Mmat), ("Gmat", js.Gmat, ts.Gmat)]
    for label, Aj, At in ops:
        assert At.offsets == Aj.offsets, label
        assert At.wrap == Aj.wrap, label
        _close(At.data.numpy(), np.asarray(Aj.data))
    for field in ("b", "z0", "omega"):
        _close(getattr(ts, field).numpy(), np.asarray(getattr(js, field)))
    targets = ("m0", "mo0", "e0") if name.startswith("lkdv") else ("m0", "e0")
    for field in targets:
        _close(float(getattr(ts, field)), float(getattr(js, field)))

    z = np.random.default_rng(0).standard_normal(js.b.shape[0])
    inv_j = js.compute_invariants(jnp.asarray(z))
    inv_t = ts.compute_invariants(torch.as_tensor(z))
    assert set(inv_j) == set(inv_t)
    for key in inv_j:
        _close(float(inv_t[key]), float(inv_j[key]))
    # and each constraint of the port evaluates to invariant − target
    for con in ts.constraints():
        target = {"mass": ts.m0, "momentum": getattr(ts, "mo0", None),
                  "energy": ts.e0}[con.name]
        _close(float(con(torch.as_tensor(z))), float(inv_t[con.name] - target))


def test_interop_rebuilds_jax_system():
    """The interop twin of a JAX system holds the same operands."""
    js = jswe.linforms(M=16)
    ts = torch_parity.to_port(js)
    _close(ts.A.data.numpy(), np.asarray(js.A.data))
    assert ts.A.offsets == js.A.offsets and ts.A.wrap == js.A.wrap
    assert ts.Lfull.scales == js.Lfull.scales
    _close(float(ts.e0), float(js.e0))


def test_constraint_helpers_match_jax():
    """grad, constraint_checker and MatComb against the JAX package's."""
    from structurepreservingiterativesolvers_torch.constraints import quadratic as tq
    from structurepreservingiterativesolvers_tpu.constraints import quadratic as jq

    js = jlkdv.linforms(**torch_parity.LKDV_EASY)
    ts = torch_parity.to_port(js)
    z = np.random.default_rng(1).standard_normal(js.b.shape[0])
    zj, zt = jnp.asarray(z), torch.as_tensor(z)
    for cj, ct in zip(js.constraints(), ts.constraints()):
        _close(ct.grad(zt).numpy(), np.asarray(cj.grad(zj)))
    _close(float(tq.constraint_checker(zt, ts.constraints())),
           float(jq.constraint_checker(zj, js.constraints())))
    u = z[: ts.n0]
    Cj = jq.MatComb((1.0, -0.5), (js.Mmat, js.Gmat))
    Ct = tq.MatComb((1.0, -0.5), (ts.Mmat, ts.Gmat))
    _close((Ct @ torch.as_tensor(u)).numpy(), np.asarray(Cj @ jnp.asarray(u)))
    _close(Ct.todense().numpy(), np.asarray(Cj.todense()))
