"""The Evolve path of the PyTorch port against the JAX package, on the CPU
in f64: the models' ``step_update``, ``evolve`` against the small evolve
records of ``reference/slice4.json``, its checkpoint, and
``deviation_plotter``.  The record's currency is checked in
``tests/test_torch_slice4_record.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tprecond
from structurepreservingiterativesolvers_torch.experiments import wrappers
from structurepreservingiterativesolvers_torch.experiments.evolve import (
    deviation_plotter,
    evolve,
)
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    default_pre_builder,
)
from structurepreservingiterativesolvers_torch.models import heat as theat
from structurepreservingiterativesolvers_torch.models import swe as tswe
from structurepreservingiterativesolvers_torch.utils.checkpoint import load_state
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.models import swe as jswe

SCRIPT = torch_parity.reference_script()


def _jax_system(problem):
    return {"lkdv": lambda: jlkdv.linforms(M=20, degree=2, N=10),
            "swe": lambda: jswe.linforms(M=16, N=5, T=1.0),
            "heat": lambda: jheat.linforms(M=16, N=5)}[problem]()


@pytest.mark.parametrize("problem", ["lkdv", "swe", "heat"])
def test_step_update_matches_jax(problem):
    js = _jax_system(problem)
    ts = torch_parity.to_port(js)
    z = np.asarray(js.z0) * 1.01 + 0.1 * np.random.default_rng(1).standard_normal(
        js.z0.shape[0])
    jn = js.step_update(jnp.asarray(z))
    tn = ts.step_update(torch.from_numpy(z))
    assert tn.A is ts.A  # the operators are reused
    for key in ("b", "z0", "m0", "mo0", "e0", "Lz0", "old_energy"):
        if hasattr(jn, key):
            torch_parity.close(getattr(tn, key).numpy(),
                               np.asarray(getattr(jn, key)), 1e-13)


def _evolve_pre(name, device="cpu"):
    """The port's preconditioner of evolution ``name``, built on its first
    system as the record's is."""
    problem, params, _, _, spec = SCRIPT.EVOLVES[name]
    if spec is None:
        return None
    model = {"swe": tswe, "heat": theat}[problem]
    s = model.linforms(device=device, **params)
    if spec == "snc":
        return default_pre_builder(problem)(s)
    builder, kwargs = spec
    return getattr(tprecond, builder)(s.A, **kwargs)


def _check_evolve(out, rec, drift_tol=1e-10):
    """An evolution against its record: the solver's counts per step, and
    the invariant series and their drifts."""
    assert list(out["steps"]) == rec["steps"]
    assert list(out["constrained_steps"]) == rec["constrained_steps"]
    assert list(out["safety"]) == rec["safety"]
    np.testing.assert_allclose(out["time"], rec["time"], rtol=1e-12)
    for key, series in rec["drift"].items():
        np.testing.assert_allclose(out[key], series, rtol=0, atol=drift_tol)
    for key, series in rec["series"].items():
        np.testing.assert_allclose(out[key], series, rtol=1e-12, atol=1e-14)


EVOLVE_SMALL = ["swe_M16_evolve", "lkdv_M50_evolve", "heat_M16_cheb8_evolve"]


@pytest.mark.parametrize("name", EVOLVE_SMALL)
def test_evolve_matches_record(name):
    problem, params, k, tol, _ = SCRIPT.EVOLVES[name]
    solver = functools.partial(wrappers.cgmres_wrapper, ortho="cgs2_fused")
    out = evolve(problem, k=k, tol=tol, pre=_evolve_pre(name), solver=solver,
                 device="cpu", **params)
    _check_evolve(out, SCRIPT.load(name)[name])
    assert out["sol"].shape == (SCRIPT.load(name)[name]["n"],)


def test_evolve_checkpoint_resume(tmp_path):
    """A checkpointed evolution resumes (the port of
    tests/test_experiments.py::test_evolve_checkpoint_resume), and an
    evolution cut after its first checkpoint resumes to the uncut result."""
    kw = dict(N=8, M=50, degree=2, k=30, tol=1e-6, device="cpu")
    full = evolve("lkdv", **kw)
    ckpt = str(tmp_path / "evolve.npz")
    evolve("lkdv", checkpoint=ckpt, checkpoint_every=4, **kw)
    step, z, series = load_state(ckpt)
    assert step == 8 and z.shape == full["sol"].shape
    resumed = evolve("lkdv", checkpoint=ckpt, checkpoint_every=4, **kw)
    np.testing.assert_allclose(resumed["dm"][-1], full["dm"][-1], atol=1e-12)

    cut = str(tmp_path / "cut.npz")
    calls = []

    class Crash(Exception):
        pass

    def crashing(system, **opts):
        if len(calls) == 5:
            raise Crash  # the run dies in its fifth step
        calls.append(1)
        return wrappers.cgmres_wrapper(system, **opts)

    with pytest.raises(Crash):
        evolve("lkdv", checkpoint=cut, checkpoint_every=4, solver=crashing, **kw)
    assert load_state(cut)[0] == 4
    rest = evolve("lkdv", checkpoint=cut, checkpoint_every=4, **kw)
    assert rest["steps"] == full["steps"][4:]
    for key in ("dm", "dmo", "de", "time"):
        np.testing.assert_allclose(rest[key], full[key], rtol=1e-12, atol=1e-13)
    torch_parity.close(rest["sol"].numpy(), full["sol"].numpy(), 1e-12)


def test_deviation_plotter_returns_both_series(tmp_path):
    out = deviation_plotter("lkdv", tol=1e-6, N=3, M=30, degree=2, k=30,
                            filename=str(tmp_path / "evolve.pdf"),
                            device="cpu")
    # both series and, as the JAX package returns it, the figure's path
    assert set(out) == {"GMRES", "CGMRES", "figure"}
    assert (tmp_path / "evolve.pdf").stat().st_size
    assert "safety" not in out["GMRES"] and all(out["CGMRES"]["safety"])
    assert out["CGMRES"]["de"][-1] < 1e-3 * out["GMRES"]["de"][-1]
