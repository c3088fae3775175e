"""The port's f32 storage mode on row-sharded operands, in one gloo job of
two ranks on the CPU (``tests/torch_spmd.py``, case ``f32``), held against
the port's unsharded f32 solve in the same rank and against the JAX
package's f32 runs on a 2-device CPU mesh, single-device and sharded
(``reference/slice17.json``; the JAX package is not run here):

* swe M=16 with the skew-normal Chebyshev (k=20, tol 4e-7·||b||, the
  wrappers' reduction mode) on both loops, and heat M=31 with the
  structured AMG (k=20, tol 1e-6·||b||; the levels of 512 rows or more
  sharded) on both loops: the unsharded solve's steps and latch, x within
  1e-5·max|x| of it; the JAX mesh record's latch, steps within one, x
  within max(1e-5·max|x|, 10x the JAX package's own gap between its
  single-device and sharded iterates);
* a 3-step f32 ``fused_evolve`` on swe M=16: the unsharded evolution's
  steps, every step certified, the solution within 1e-5·max|x|;
* the ranks' results equal, bit for bit (every flag comes from
  all-reduced values), and the gathered f64 products from f32 storage of
  heat M=31's sharded energy matrix and operator (the windowed mixed #1's
  plain version) the unsharded ones, bit for bit.
"""

import numpy as np
import pytest

import torch_parity
from torch_spmd import run_job

SCRIPT = torch_parity.reference_script()
REC = SCRIPT.load("swe_M16_snc_sharded_f32")
WORLD = 2
X_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_job(WORLD, ("f32",), tmp_path_factory.mktemp("gloo2_f32"))


def _against(run, name):
    """One sharded f32 solve of each loop against the unsharded one and
    against the JAX mesh record ``name``."""
    rec = REC[name]
    jx1, jx2 = (np.asarray(rec[k]["x"]) for k in ("single", "sharded"))
    own = np.abs(jx1 - jx2).max()
    for loop in ("host", "while"):
        r = run[loop]
        info, ref = r["info"], r["info_ref"]
        scale = np.abs(r["x_ref"]).max()
        assert info["steps"] == ref["steps"], loop
        assert info["safety"] == ref["safety"] is True, loop
        assert np.abs(r["x"] - r["x_ref"]).max() <= X_RTOL * scale, loop
        assert info["safety"] == rec["sharded"]["safety"]
        assert abs(info["steps"] - rec["sharded"]["steps"]) <= 1, loop
        bar = max(X_RTOL * np.abs(jx2).max(), 10.0 * own)
        assert np.abs(r["x"] - jx2).max() <= bar, loop
    assert abs(run["tol_abs"] - rec["tol_abs"]) <= 1e-6 * rec["tol_abs"]


def test_sharded_f32_swe(ranks):
    out = ranks[0]["f32"]
    _against(out["swe"], "swe_M16_snc_sharded_f32")


def test_sharded_f32_heat_amg(ranks):
    out = ranks[0]["f32"]
    _against(out["heat"], "heat_M31_amg_sharded_f32")


def test_sharded_f32_fused_evolve(ranks):
    out = ranks[0]["f32"]
    single, sharded = out[("fused", "single")], out[("fused", "sharded")]
    assert list(sharded["steps"]) == list(single["steps"])
    assert all(int(v) == 1 for v in sharded["safety"])
    assert all(int(v) == 1 for v in single["safety"])
    scale = np.abs(single["sol"]).max()
    assert np.abs(sharded["sol"] - single["sol"]).max() <= X_RTOL * scale


def test_sharded_f32_ranks_agree(ranks):
    """The ranks' results equal, bit for bit; and the f64 products from f32
    storage of the sharded operators (a ShardedDIA's through the mixed
    form's windowed launch, its plain version here) equal the unsharded
    ones, bit for bit: each row sums the same diagonals in the same
    order."""
    for key, (sharded, whole) in ranks[0]["f32"]["f64_products"].items():
        assert sharded.dtype == whole.dtype == np.float64, key
        assert np.array_equal(sharded, whole), key
    a, b = ranks[0]["f32"], ranks[1]["f32"]
    for key in ("swe", "heat"):
        for loop in ("host", "while"):
            assert np.array_equal(a[key][loop]["x"], b[key][loop]["x"])
            assert a[key][loop]["info"]["steps"] == b[key][loop]["info"]["steps"]
    assert np.array_equal(a[("fused", "sharded")]["sol"],
                          b[("fused", "sharded")]["sol"])
