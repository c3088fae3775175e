"""The port's ``fused_evolve`` on the CPU at swe M=512 (n = 786,432) with
the skew-normal Chebyshev, held to the JAX records the card run is held to:
``swe_M512_snc_fused`` (``reference/slice8.json``, the JAX ``fused_evolve``,
warm-started) and, started from zero each step, ``swe_M512_snc_evolve``
(``reference/slice4.json``, the JAX ``evolve``).  Steps per step within
one, every latch certified, the drift bars of
``tests/test_experiments.py::test_fused_evolve_swe``, and, warm, the
max-norm of the last solution within 1e-8.  ``slow``: several minutes."""

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.experiments.evolve import (
    fused_evolve,
)
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    default_pre_builder,
)
from structurepreservingiterativesolvers_torch.models import swe

SCRIPT = torch_parity.reference_script()


@pytest.mark.slow
@pytest.mark.parametrize("name, warm", [("swe_M512_snc_fused", True),
                                        ("swe_M512_snc_evolve", False)])
def test_fused_evolve_swe_m512_matches_record(name, warm):
    rec = SCRIPT.load(name)[name]
    params = rec["config"]["params"]
    pre = default_pre_builder("swe")(swe.linforms(device="cpu", **params))
    assert pre.degree == rec["degree"]
    out = fused_evolve("swe", k=rec["config"]["k"], tol=rec["config"]["tol"],
                       pre=pre, warm_start=warm, ortho="cgs2_fused",
                       device="cpu", **params)
    steps = rec["steps"]
    assert np.all(np.abs(np.asarray(out["steps"]) - np.asarray(steps)) <= 1)
    assert np.all(out["safety"] == 1)
    e0 = abs(rec["series"]["energy"][0])
    assert np.all(out["dm"] < 1e-9) and np.all(out["de"] / e0 < 1e-13)
    if warm:
        sol_max = float(out["sol"].abs().max())
        assert abs(sol_max - rec["sol_max"]) <= 1e-8 * rec["sol_max"]
    assert bool(torch.isfinite(out["sol"]).all())
