"""The JAX record of the third slice (``reference/slice3.json``): heat with
the Chebyshev and Neumann polynomial preconditioners, the entries that the
card run of ``chip_smoke.py`` is held to.  Each test regenerates an entry
with the JAX package on the CPU and compares it with the committed one:
counts and configuration equal, residuals and deviations to 1e-6, invariants
and the spectral bounds to 1e-12.  The M=64 entries are tier-1; the
others are ``slow``.
"""

import pytest

import torch_parity


@pytest.mark.parametrize("name", ["heat_M64_cheb8", "heat_M64_neu4"])
def test_reference_record_is_current(name):
    """Regenerate a small entry of the JAX record of the third slice
    (``reference/slice3.json``) and compare."""
    script = torch_parity.reference_script()
    torch_parity.check_record(script.record(name), script.load(name)[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", ["heat_M32_cheb8", "heat_M256_cheb8",
                                  "heat_M1024_cheb8", "heat_M1024_neu4"])
def test_reference_record_large(name):
    """The other entries: M=32, the configuration that
    ``tests/test_torch_precond.py`` runs live against the JAX package, and
    the large ones the card run is held to (n = 66,049 and 1,050,625;
    minutes on the CPU)."""
    script = torch_parity.reference_script()
    torch_parity.check_record(script.record(name), script.load(name)[name])
