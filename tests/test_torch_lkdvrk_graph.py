"""lkdvRK on the port's device core (``solvers/cgmres.py::DeviceCore``,
each step a CUDA graph on the card, run eagerly here), in f64 on the CPU,
against the JAX records ``reference/slice7.json`` and
``reference/slice12.json`` (``scripts/make_torch_reference.py``) and the
port's host loop; and the device core's general constraints and history.

* The M=50, (3, 2) TimedSolve row with the RAS + Neumann composite on the
  device core, held to the record as the host loop is
  (``torch_parity.check_lkdvrk_row``), and its CGMRES solve against the
  host loop: equal steps and latch, x within 1e-10 of max|x|.
* ``fused_evolve("lkdvrk")`` at M=20, (3, 2), N=4 against the JAX
  ``evolve`` record, which chains the stepped systems: every step
  certified, steps at most the record's, each drift at most max(1e-10, 10×
  the record's).  The JAX ``fused_evolve`` record of the same evolution
  steps every system from the first one's state: its energy drift from
  the third step on is above 1e-3, and the port's stays below 1e-10.
* A ``GeneralConstraint`` (lkdv degree 3, M=50, the energy as a callable)
  and ``history`` (lkdv degree 2, M=50) on the device core against the host
  loop and the JAX device core's record: steps and latch equal, x within
  1e-10 of the host loop's (the history within 1e-12 relative), and within
  max(1e-8, 10× the record's own drift under a 1e-15 change of b) of the
  record's.
* The model's repair: the RK weights are one device tensor carried by
  ``step_update``, so the stage-mapped constraints' operators keep their
  key (one cached core serves a whole evolution) and a step reads nothing
  on the host (it runs on ``meta`` tensors).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.constraints import GeneralConstraint
from structurepreservingiterativesolvers_torch.experiments import error_sweep
from structurepreservingiterativesolvers_torch.experiments.evolve import (
    fused_evolve,
)
from structurepreservingiterativesolvers_torch.models import lkdv, lkdvrk

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the module (the solvers package exports a function of its name)
tcgmres = importlib.import_module(
    "structurepreservingiterativesolvers_torch.solvers.cgmres")
REC = torch_parity.slice12()


@pytest.fixture(scope="module")
def fused():
    """The port's ``fused_evolve`` of the records' evolution, with the
    composite built on its first system."""
    cfg = REC["lkdvrk_M20_evolve"]["config"]
    s0 = lkdvrk.linforms(device="cpu", **cfg["params"])
    pre = tts.default_pre_builder("lkdvrk")(s0)
    return fused_evolve("lkdvrk", k=cfg["k"], tol=cfg["tol"], pre=pre,
                        device="cpu", **cfg["params"])


def test_m50_row_on_the_device_core():
    row = torch_parity.check_lkdvrk_row("lkdvrk_M50_deg3_s2", loop="while")
    assert row["time_capture"] == 0.0  # nothing to capture on the CPU
    cfg = torch_parity.slice7()["lkdvrk_M50_deg3_s2"]["config"]
    s = lkdvrk.linforms(device="cpu", **cfg["params"])
    kw = dict(k=cfg["k"], tol=cfg["tol"], constraints=s.constraints(),
              pre=tts.default_pre_builder("lkdvrk")(s))
    xh, ih = tcgmres.cgmres(s.A, s.b, **kw)
    xd, idv = tcgmres.cgmres(s.A, s.b, loop="while", **kw)
    for key in ("steps", "constrained_steps", "safety"):
        assert idv[key] == ih[key], key
    assert idv["deviation"] <= 1e-10
    torch_parity.close(xd.numpy(), xh.numpy(), 1e-10)


def test_fused_evolve_matches_jax_evolve_record(fused):
    rec = REC["lkdvrk_M20_evolve"]
    assert len(fused["steps"]) == len(rec["steps"])
    assert np.all(fused["safety"] == 1) and not fused["fallbacks"].any()
    assert np.all(fused["steps"] <= np.asarray(rec["steps"]))
    np.testing.assert_allclose(fused["time"], rec["time"][1:], rtol=1e-12)
    for key, drift in rec["drift"].items():
        bar = np.maximum(1e-10, 10.0 * np.asarray(drift[1:]))
        assert np.all(fused[key] <= bar), key
    # sol is the last stage vector
    assert fused["sol"].shape == (2 * 3 * lkdvrk.linforms(
        device="cpu", **rec["config"]["params"]).n0,)


def test_jax_fused_evolve_state_fault_is_not_copied(fused):
    """The JAX ``fused_evolve`` runs ``sys0.step_update(z_prev)`` each step:
    from the third step on it restarts from the initial state plus the last
    step's increment, and its energy leaves the invariant; its ``evolve``
    of the same steps does not."""
    jf, je = REC["lkdvrk_M20_fused"], REC["lkdvrk_M20_evolve"]
    assert jf["config"]["params"] == je["config"]["params"]
    assert jf["drift"]["de"][2] > 1e-3 and max(je["drift"]["de"]) < 1e-10
    assert np.all(fused["de"] < 1e-10) and np.all(fused["dmo"] < 1e-10)
    # the port's energy series is the chained one, not the faulty one
    torch_parity.close(fused["energy"], je["series"]["energy"][1:], 1e-12)
    assert abs(fused["energy"][2] - jf["series"]["energy"][2]) > 1e-3


def _energy(s):
    def energy(x):
        u, _, w = torch.split(x, s.n0)
        return (0.5 * torch.dot(w, s.Mmat @ w) - 0.5 * torch.dot(u, s.Mmat @ u)
                - s.e0)

    return GeneralConstraint(func=energy, name="energy")


def _against_host_and_record(name, **extra):
    rec = REC[name]
    cfg = rec["config"]
    s = lkdv.linforms(device="cpu", **cfg["params"])
    cons = s.constraints()
    if cfg["kind"] == "general":
        cons = [*cons[:2], _energy(s)]
    kw = dict(k=cfg["k"], tol=cfg["tol"], constraints=cons, **extra)
    xh, ih = tcgmres.cgmres(s.A, s.b, **kw)
    xd, idv = tcgmres.cgmres(s.A, s.b, loop="while", **kw)
    for key in ("steps", "constrained_steps", "safety"):
        assert idv[key] == ih[key] == rec[key], key
    assert idv["deviation"] <= 1e-10
    torch_parity.close(xd.numpy(), xh.numpy(), 1e-10)
    torch_parity.close(xd.numpy(), rec["x"],
                       max(1e-8, 10.0 * rec["own_drift"]["x"]))
    inv = s.compute_invariants(xd)
    for key, attr in (("mass", "m0"), ("momentum", "mo0"), ("energy", "e0")):
        assert abs(float(inv[key] - getattr(s, attr))) <= 1e-10, key
    return rec, ih, idv


def test_general_constraint_on_the_device_core():
    """The energy as a callable: a Taylor model about the warm coefficients
    in ``kkt_start``, the true g re-checked in ``kkt_finish``; a second
    solve with the same constraint objects replays the cached core."""
    _, _, idv = _against_host_and_record("lkdv_M50_general")
    core = tcgmres.last_core()
    assert core.general == (False, False, True)
    assert not bool(core.linear[2])


def test_history_on_the_device_core():
    rec, ih, idv = _against_host_and_record("lkdv_M50_history",
                                            history=True)
    xs = idv["x"]
    assert xs.shape == ih["x"].shape == (rec["steps"] + 1, rec["n"])
    torch_parity.close(xs.numpy(), ih["x"].numpy(), 1e-12)
    torch_parity.close(xs.abs().amax(1).numpy(), rec["xs_max"],
                       max(1e-8, 10.0 * rec["own_drift"]["xs_max"]))


def test_model_keys_and_host_reads():
    """``step_update`` carries the one weights tensor: the constraints'
    operators keep their ``_key``, and ``step_update``, ``constraints()``
    and ``compute_invariants`` run on ``meta`` tensors, which hold no
    values, so a host read or a host copy of a value there would raise or
    leave the device (the kernel wrappers refuse ``meta``, so the operators
    are dense)."""
    s = lkdvrk.linforms(M=10, N=4, degree=3, tstages=2, T=0.4, device="cpu")
    z = torch.linspace(-1.0, 1.0, s.b.shape[0], dtype=torch.float64)
    s2 = s.step_update(z)
    assert s2.bw is s.bw and s2._weights() is s.bw
    before, after = s.constraints(), s2.constraints()
    for a, b in zip(before, after):
        assert tcgmres._con_key(a) == tcgmres._con_key(b), a.name
    meta = dict(dtype=torch.float64, device="meta")
    ops = {nm: torch.empty(getattr(s, nm).shape, **meta)
           for nm in ("A", "Mmat", "Gmat", "Minv")}
    vecs = {nm: torch.empty_like(getattr(s, nm), device="meta")
            for nm in ("b", "z0", "omega", "m0", "mo0", "e0", "bw")}
    ms = dataclasses.replace(s, **ops, **vecs)
    zm = torch.empty(s.b.shape, **meta)
    stepped = ms.step_update(zm)
    cons = stepped.constraints()
    inv = stepped.compute_invariants(zm)
    assert all(t.device.type == "meta" for t in (
        stepped.b, stepped.z0, stepped.e0, inv["energy"], cons[0].v,
        cons[2].c))
    assert all(c.M is None or c.M.b is ms.bw for c in cons)


def test_error_sweep_captures_one_core(tmp_path, monkeypatch):
    """``run_single(loop="while")`` builds one device core for the whole
    evolution (the stepped systems share A, the composite and the
    constraints' operators) and gives the host loop's errors."""
    built = []
    base = tcgmres.DeviceCore

    class Counted(base):
        def __init__(self, *args, **kwargs):
            built.append(1)
            super().__init__(*args, **kwargs)

    tcgmres.clear_core_cache()
    monkeypatch.setattr(tcgmres, "DeviceCore", Counted)
    args = dict(N=3, M=20, k=50, tmpdir=str(tmp_path), device="cpu")
    dev = error_sweep.run_single("CGMRES", 3, 2, 1e-3, loop="while", **args)
    assert len(built) == 1
    host = error_sweep.run_single("CGMRES", 3, 2, 1e-3, **args)
    assert dev["steps"] == host["steps"]
    torch_parity.close(dev["err"], host["err"], 1e-10)
    assert max(dev["dm"]) <= 1e-12
    # at tol=1e-3 the energy drifts by 3e-9 at the second step on both
    # loops, where step_update re-derives the auxiliary fields
    np.testing.assert_allclose(dev["de"], host["de"], rtol=0,
                               atol=1e-12 * abs(host["energy"][0]))
