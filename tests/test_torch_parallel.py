"""The port's row-sharded solves in one gloo job of four ranks on the CPU
(``tests/torch_spmd.py``), held against the port's own unsharded solve in
the same rank and against the JAX package's sharded and single-device runs
of ``tests/test_parallel.py`` (``reference/slice14.json``, an 8-device CPU
mesh), with that test's tolerances; and the ranks against each other, bit
for bit (every rank's flags come from all-reduced values).

At four ranks swe M=8 (n = 192) holds 48 rows a rank against offsets of
+-79: its window is wider than a shard and reaches all three peers."""

import json

import numpy as np
import pytest

from torch_spmd import halo_matrices, run_job

REFERENCE = json.loads(
    (__import__("pathlib").Path(__file__).resolve().parents[1]
     / "structurepreservingiterativesolvers_torch" / "reference"
     / "slice14.json").read_text())
WORLD = 4
CASES = ("swe", "ell", "halo", "halo_gmres", "heat_amg", "snc", "fused")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_job(WORLD, CASES, tmp_path_factory.mktemp("gloo4"))


def _check_solve(run, rec, rtol, atol, certify=True):
    """A sharded solve of one loop: the same steps as the port's unsharded
    one and the JAX record's, x within the tolerances of both, and, for
    CGMRES, the latch and the deviation."""
    info = run["info"]
    assert info["steps"] == run["info_ref"]["steps"] == rec["sharded"]["steps"]
    np.testing.assert_allclose(run["x"], run["x_ref"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(run["x"], rec["sharded"]["x"], rtol=rtol,
                               atol=atol)
    if "single" in rec:
        np.testing.assert_allclose(run["x"], rec["single"]["x"], rtol=rtol,
                                   atol=atol)
    if certify:
        assert info["safety"] is True
        assert info["deviation"] < 1e-10


def test_sharded_cgmres_swe_matches_single(ranks):
    """swe M=8, k=15, tol=1e-8, on both loops and with the fused CGS2 twin:
    steps, latch and x (rtol 1e-10, atol 1e-12) as the unsharded solve and
    the JAX record."""
    out, rec = ranks[0]["swe"], REFERENCE["swe_M8_sharded"]
    lo, hi, n_local, peers = out["window"]
    assert (lo, hi, n_local) == (79, 79, 48) and lo > n_local
    assert peers == (1, 2, 3)
    for run in (out["host"], out["while"], out["fused"]):
        _check_solve(run, rec, 1e-10, 1e-12)


def test_sharded_gmres_ell(ranks):
    """The ELL tridiagonal, n = 128, GMRES k=60: x within 1e-8."""
    rec = REFERENCE["ell_tridiag_n128"]
    for loop in ("host", "while"):
        _check_solve(ranks[0]["ell"][loop], rec, 1e-8, 0.0, certify=False)


def test_halo_spmv_matches_local(ranks):
    """The ring-halo SpMV at n = 256 (wrapped offsets +-2; the unwrapped
    tridiagonal) against the unsharded product bit for bit, scipy's and the
    JAX record's within 1e-12, reaching the ring neighbours only; the
    sharded product of a block of three vectors (#1b's windowed twin)
    against the unsharded block product."""
    Ah, Ah2, x = halo_matrices()
    rec = REFERENCE["halo_n256"]
    for key, M, ring in (("wrapped", Ah, (1, 3)), ("unwrapped", Ah2, (1,))):
        h = ranks[0]["halo"][key]
        np.testing.assert_array_equal(h["y"], h["y_local"])
        np.testing.assert_allclose(h["y"], M @ x, rtol=1e-12)
        np.testing.assert_allclose(h["y"], rec[key]["y"], rtol=1e-12)
        np.testing.assert_array_equal(h["Y"], h["Y_local"])
        assert h["peers"] == ring


def test_gmres_with_halo_operator(ranks):
    """``HaloDia`` as the solvers' A: GMRES k=80, tol=1e-10 on both loops,
    x as scipy's direct solve (rtol 1e-7) and as the JAX record's."""
    rec = REFERENCE["halo_gmres_n256"]
    for loop in ("host", "while"):
        run = ranks[0]["halo_gmres"][loop]
        np.testing.assert_allclose(run["x"], rec["spsolve"], rtol=1e-7)
        _check_solve(run, rec, 1e-8, 1e-10, certify=False)


def test_sharded_amg_preconditioned_heat(ranks):
    """heat M=31 with the AMG: the fine level sharded, the coarse one whole
    (replicate_below=512), k=25, tol=1e-8 on both loops; deviation below
    1e-12."""
    out, rec = ranks[0]["heat_amg"], REFERENCE["heat_M31_amg_sharded"]
    assert out["levels"] == [(1024, True), (121, False)]
    assert [n for n, _ in out["levels"]] == rec["amg_levels"]
    for loop in ("host", "while"):
        _check_solve(out[loop], rec, 1e-8, 1e-10)
        assert out[loop]["info"]["deviation"] < 1e-12


def test_sharded_polynomial_preconditioner_swe(ranks):
    """swe M=8 with the skew-normal Chebyshev as chained sharded products,
    k=15, tol=1e-8 on both loops: x within rtol 1e-8, atol 1e-10."""
    rec = REFERENCE["swe_M8_snc_sharded"]
    for loop in ("host", "while"):
        _check_solve(ranks[0]["snc"][loop], rec, 1e-8, 1e-10)


def test_fused_evolve_sharded(ranks):
    """``fused_evolve("swe", N=4, M=8, k=20, tol=1e-7, T=1.0, mesh=)``: the
    unsharded evolution's steps, energy drift (atol 1e-10) and solution
    (1e-10), every step certified; against the JAX record's sharded run the
    drift within 1e-10 and at most its steps (the port's warm-start pin
    certifies sooner, tests/test_torch_fused.py)."""
    out, rec = ranks[0]["fused"], REFERENCE["swe_M8_fused_sharded"]
    sh, single = out["sharded"], out["single"]
    assert list(sh["steps"]) == list(single["steps"])
    np.testing.assert_allclose(sh["de"], single["de"], atol=1e-10)
    np.testing.assert_allclose(sh["sol"], single["sol"], rtol=0, atol=1e-10)
    assert np.all(sh["safety"] == 1)
    np.testing.assert_allclose(sh["de"], rec["sharded"]["de"], atol=1e-10)
    assert np.all(sh["steps"] <= np.asarray(rec["sharded"]["steps"]))


def test_ranks_agree_bit_for_bit(ranks):
    """Every rank took the same branches: the same steps, latches,
    residual traces and deviations, and the same gathered x, to the bit."""
    def flat(obj, path=""):
        if isinstance(obj, dict):
            for key, val in sorted(obj.items()):
                if key != "_seconds":
                    yield from flat(val, f"{path}/{key}")
        elif isinstance(obj, (list, tuple)) and path.endswith("window"):
            return
        else:
            yield path, obj

    base = dict(flat(ranks[0]))
    assert len(base) > 50
    for r in ranks[1:]:
        mine = dict(flat(r))
        assert mine.keys() == base.keys()
        for key, val in base.items():
            if key.endswith("window") or key.endswith("peers"):
                continue
            np.testing.assert_array_equal(np.asarray(mine[key]),
                                          np.asarray(val), err_msg=key)
