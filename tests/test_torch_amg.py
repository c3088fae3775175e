"""The structured AMG of the PyTorch port against the JAX package's, on
heat M=64 in f64 (three levels: 4,225 → 484 → 64): the setup, one V-cycle
on identical levels, the refusals and the greedy fallback, and the
committed JAX record of heat M=64, whose solves run with that AMG.

Tolerances: the setup is the same device program in another framework; the
power iteration for ρ, the probes and the dense inverse sum in another
order, so the level data agree to 1e-12 relative, and the level sizes and
offsets exactly.  One V-cycle on identical levels
(``interop.amg_hierarchy``) agrees to 1e-12.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import interop
from structurepreservingiterativesolvers_torch.models import heat as theat

# the module (the precond package exports a function of the same name,
# as the JAX package's does)
tamg = importlib.import_module(
    "structurepreservingiterativesolvers_torch.precond.amg")

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

# the JAX package's precond namespace exports a function of this name
jamg = importlib.import_module("structurepreservingiterativesolvers_tpu.precond.amg")
_close = torch_parity.close


@pytest.fixture(scope="module")
def systems():
    return torch_parity.heat_systems()


def test_amg_setup_matches_jax(systems):
    js, ts, pj = systems(64)
    pt = tts.default_pre_builder("heat")(ts)
    assert [L.A.shape for L in pt.levels] == [tuple(L.A.shape) for L in pj.levels]
    assert [L.A.shape[0] for L in pt.levels] == [4225, 484, 64]
    for Lt, Lj in zip(pt.levels, pj.levels):
        assert Lt.A.offsets == tuple(Lj.A.offsets)
        _close(Lt.A.data.numpy(), np.asarray(Lj.A.data), 1e-12)
        _close(Lt.dinv.numpy(), np.asarray(Lj.dinv), 1e-12)
        assert (Lt.P is None) == (Lj.P is None)
        if Lt.P is not None:
            _close(Lt.P.S.data.numpy(), np.asarray(Lj.P.S.data), 1e-12)
            _close(Lt.R.S.data.numpy(), np.asarray(Lj.R.S.data), 1e-12)
            assert (Lt.P.C1, Lt.P.Cc1, Lt.R.C2, Lt.R.Cc2) == (
                Lj.P.C1, Lj.P.Cc1, Lj.R.C2, Lj.R.Cc2)
    _close(pt.coarse_inv.numpy(), np.asarray(pj.coarse_inv), 1e-12)


def test_vcycle_matches_jax(systems):
    _, _, pj = systems(64)
    pt = interop.amg_hierarchy(**torch_parity.export_amg(pj), device="cpu")
    v = np.random.default_rng(1).standard_normal(4225)
    _close(pt(torch.as_tensor(v)).numpy(), np.asarray(pj(jnp.asarray(v))), 1e-12)
    torch.testing.assert_close(pt.solve(torch.as_tensor(v)),
                               pt(torch.as_tensor(v)), rtol=0, atol=0)


def _asymmetric(n_side=17):
    """A grid-local operator whose upper and lower bands differ."""
    n = n_side * n_side
    return sp.diags([np.full(n - 1, -1.0), np.full(n, 4.0), np.full(n - 1, -0.5)],
                    [-1, 0, 1], format="csr")


def test_amg_refusals():
    A = _asymmetric()
    grid = (17, 17)
    with pytest.raises(tamg._StructuredSetupError):
        tamg.amg(A, grid=grid, setup="device", device="cpu")
    with pytest.raises(jamg._StructuredSetupError):
        jamg.amg(A, grid=grid, setup="device")
    # where the structured setup refuses, both packages warn and fall back
    # to the greedy host setup; without grid= both build it directly
    with pytest.warns(UserWarning, match="falling back"):
        pj = jamg.amg(A, grid=grid)
    with pytest.warns(UserWarning, match="falling back"):
        pt = tamg.amg(A, grid=grid, device="cpu")
    sizes = [L.A.shape[0] for L in pt.levels]
    assert len(sizes) >= 2
    assert sizes == [int(L.A.shape[0]) for L in pj.levels]
    assert [type(L.A).__name__ for L in pt.levels] == [
        type(L.A).__name__ for L in pj.levels]
    assert [L.A.shape[0] for L in tamg.amg(A, device="cpu").levels] == [
        int(L.A.shape[0]) for L in jamg.amg(A).levels] == sizes
    At = theat.linforms(M=16, device="cpu").A
    with pytest.raises(ValueError):
        tamg.amg(At)  # a device operator needs grid=


def test_reference_record_is_current(systems):
    """Regenerate the heat_M64 entry of the committed JAX record and
    compare."""
    script = torch_parity.reference_script()
    new = script.record("heat_M64", s=systems(64)[0])
    torch_parity.check_record(new, script.load("heat_M64")["heat_M64"])
