"""The committed JAX record ``reference/slice4.json``, which the card run is
held against, regenerated from the JAX package on the CPU for its small
entries; its M=512 entries are ``slow`` tests."""

import math

import numpy as np
import pytest

import torch_parity

SCRIPT = torch_parity.reference_script()
EVOLVE_SMALL = ["swe_M16_evolve", "lkdv_M50_evolve", "heat_M16_cheb8_evolve"]


def _check_evolve_record(new, rec):
    assert new["config"] == rec["config"] and new["n"] == rec["n"]
    for key in ("degree", "lmin", "lmax"):
        if key in rec:
            assert math.isclose(new[key], rec[key], rel_tol=1e-12), key
    for key in ("steps", "constrained_steps", "safety", "time"):
        assert new[key] == rec[key], key
    for part in ("series", "drift"):
        for key, series in rec[part].items():
            np.testing.assert_allclose(new[part][key], series, rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("name", ["swe_M32_snc", "swe_M64_snc", *EVOLVE_SMALL])
def test_reference_record_is_current(name):
    """Regenerate an entry of the committed JAX record and compare."""
    rec = SCRIPT.load(name)[name]
    if name in SCRIPT.EVOLVES:
        _check_evolve_record(SCRIPT.record_evolve(name), rec)
    else:
        new = SCRIPT.record(name)
        torch_parity.check_record(new, rec)
        assert new["degree"] == rec["degree"]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["swe_M512_snc", "swe_M512_snc_evolve"])
def test_reference_record_swe_m512(name):
    """The full-size entries (n = 786,432), which the card run is held to."""
    rec = SCRIPT.load(name)[name]
    if name in SCRIPT.EVOLVES:
        _check_evolve_record(SCRIPT.record_evolve(name), rec)
    else:
        torch_parity.check_record(SCRIPT.record(name), rec)
