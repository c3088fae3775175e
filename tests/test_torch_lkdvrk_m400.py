"""The port's lkdvRK rows at the reference's error-sweep grid, M=400, N=10
(lkdvRK/ErrorGenerator.py:28-39), against the JAX package's record
(``reference/slice7.json``), on the CPU in f64.  Each row builds its RAS
inverses on the host twice (0.29, 1.02 and 2.60 GB in f64), so these
tests are ``slow``: they stay out of the tier-1 run and are run by hand.
The same rows run on the card in ``chip_smoke.py``.

Bars as in ``tests/test_torch_lkdvrk_record.py``; the evolution's errors
within max(1e-6, 10× the record's own drift), the bar of ``chip_smoke.py``.
"""

import pytest

import torch_parity
from structurepreservingiterativesolvers_torch.experiments import error_sweep

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("name", ["lkdvrk_M400_deg3_s2", "lkdvrk_M400_deg4_s3",
                                  "lkdvrk_M400_deg5_s4"])
def test_reference_record_m400(name):
    torch_parity.check_lkdvrk_row(name)


def test_reference_record_m400_evolve(tmp_path):
    name = "lkdvrk_M400_deg3_s2_evolve"
    cfg = torch_parity.slice7()[name]["config"]
    (degree, tstages, tol), = cfg["grid"]
    out = error_sweep.run_single("CGMRES", degree, tstages, tol, N=cfg["N"],
                                 M=cfg["M"], k=cfg["k"], tmpdir=str(tmp_path),
                                 device="cpu")
    torch_parity.check_lkdvrk_runs([out], name, floor=1e-6)
