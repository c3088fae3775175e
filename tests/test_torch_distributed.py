"""The port's distribution layer across processes on the CPU: one gloo job of
two ranks (``tests/torch_spmd.py``), where the left and the right ring
neighbour are one peer, and the refusals the port shares with the JAX
package; ``dist-bench`` as a job of one and then of two processes, as the
JAX ``tests/test_distributed.py`` runs it; the global meshes in one
process."""

import json

import numpy as np
import pytest

from torch_spmd import halo_matrices, run_job

REFERENCE = json.loads(
    (__import__("pathlib").Path(__file__).resolve().parents[1]
     / "structurepreservingiterativesolvers_torch" / "reference"
     / "slice14.json").read_text())
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_job(WORLD, ("halo", "swe", "fused_fields", "refusals",
                           "meshes", "cg"), tmp_path_factory.mktemp("gloo2"))


def test_same_peer_ring_halo(ranks):
    """At two ranks both halos of the wrapped operator come from the one
    peer, as one message in the window's order: the product is the
    unsharded one bit for bit, and scipy's within 1e-12."""
    Ah, Ah2, x = halo_matrices()
    for rank, r in enumerate(ranks):
        for key, M in (("wrapped", Ah), ("unwrapped", Ah2)):
            h = r["halo"][key]
            assert h["peers"] == (1 - rank,)
            np.testing.assert_array_equal(h["y"], h["y_local"])
            np.testing.assert_array_equal(h["Y"], h["Y_local"])
            np.testing.assert_allclose(h["y"], M @ x, rtol=1e-12)


def test_sharded_swe_two_ranks(ranks):
    """swe M=8 at two ranks (96 rows a rank, offsets +-79): both loops take
    the JAX record's steps, x within rtol 1e-10, atol 1e-12 of the
    unsharded solve and of the record, certified; the ranks agree."""
    rec = REFERENCE["swe_M8_sharded"]
    for loop in ("host", "while"):
        run = ranks[0]["swe"][loop]
        assert run["info"]["steps"] == rec["sharded"]["steps"]
        assert run["info"]["safety"] is True
        np.testing.assert_allclose(run["x"], run["x_ref"], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(run["x"], rec["sharded"]["x"], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_array_equal(run["x"], ranks[1]["swe"][loop]["x"])
        assert run["info"]["deviation"] == ranks[1]["swe"][loop]["info"]["deviation"]


def test_sharded_cg_two_ranks(ranks):
    """CG on heat M=31 with the structured AMG, the fine level sharded
    over two ranks (k=200, tol=1e-8): every inner product and norm is
    all-reduced, so both loops take the unsharded solve's steps, with the
    gathered x within 1e-10 of its max-norm and the residual trace within
    1e-10 relative (the last entry, the true residual near tol, within
    1e-10 of the first); the ranks agree bit for bit."""
    for loop in ("host", "while"):
        run = ranks[0]["cg"][loop]
        assert run["info"]["steps"] == run["info_ref"]["steps"] < 200
        np.testing.assert_allclose(run["x"], run["x_ref"], rtol=0,
                                   atol=1e-10 * np.abs(run["x_ref"]).max())
        res, ref = run["info"]["res"], run["info_ref"]["res"]
        np.testing.assert_allclose(res[:-1], ref[:-1], rtol=1e-10)
        np.testing.assert_allclose(res[-1], ref[-1], rtol=0,
                                   atol=1e-10 * ref[0])
        np.testing.assert_array_equal(run["x"], ranks[1]["cg"][loop]["x"])
    np.testing.assert_array_equal(ranks[0]["cg"]["host"]["x"],
                                  ranks[0]["cg"]["while"]["x"])

def test_fused_evolve_fields_sharded(ranks):
    """``fused_evolve(mesh=)`` on lkdv and lkdvRK, whose states split into
    fields (the system held whole, the solve sharded) at two ranks: every
    step certified, the steps within one of the unsharded evolution's (lkdv
    at k=30 stops near tol, where roundoff moves a count), the drifts
    within 1e-10 and the last solution within 1e-7 of its max-norm; the
    ranks agree bit for bit."""
    out = ranks[0]["fused_fields"]
    for problem in ("lkdv", "lkdvrk"):
        sh, single = out[(problem, "sharded")], out[(problem, "single")]
        assert np.all(sh["safety"] == 1)
        assert np.all(np.abs(sh["steps"] - single["steps"]) <= 1)
        for key in ("dm", "dmo", "de"):
            np.testing.assert_allclose(sh[key], single[key], atol=1e-10)
        np.testing.assert_allclose(sh["sol"], single["sol"], rtol=0,
                                   atol=1e-7 * np.abs(single["sol"]).max())
        np.testing.assert_array_equal(
            sh["sol"], ranks[1]["fused_fields"][(problem, "sharded")]["sol"])


def test_refusals(ranks):
    """A BSR and a general constraint are refused under a mesh, as the JAX
    package refuses them; the halo SpMV refuses a halo wider than a shard,
    and a vector of n rows that the ranks do not divide is refused."""
    ref = ranks[0]["refusals"]
    assert ref["bsr"][0] == "NotImplementedError" and "BSR" in ref["bsr"][1]
    assert ref["general"][0] == "NotImplementedError"
    assert "QuadraticConstraint" in ref["general"][1]
    assert ref["halo_wide"] == ("ValueError", "halo wider than a local shard")
    assert ref["indivisible"][0] == "ValueError"
    assert ranks[1]["refusals"] == ref


def test_global_mesh_two_ranks(ranks):
    """The global mesh spans both processes, host-major; the (hosts, chips)
    mesh is one host of two chips; rank 0 is the coordinator."""
    for rank, r in enumerate(ranks):
        m = r["meshes"]
        assert m["global"] == (2, rank, {"rows": 2})
        assert m["host_chip"] == {"hosts": 1, "chips": 2}
        assert m["ranks"] == [[0, 1]]
        assert m["coordinator"] is (rank == 0)


def test_global_mesh_host_major_single_process():
    """In one process the global mesh and the (hosts, chips) mesh have one
    device, and this process is the coordinator.  Without a card the
    default device, the card, raises: gloo runs only where it is asked
    for."""
    import torch
    import torch.distributed as dist

    from structurepreservingiterativesolvers_torch.parallel import (
        global_mesh,
        host_chip_mesh,
        init_distributed,
        is_coordinator,
    )

    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        # the card is the default: the CPU only where it is asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed()
        assert not dist.is_initialized()
    try:
        assert init_distributed(device="cpu") == (0, 1)
        assert init_distributed(device="cpu") == (0, 1)  # idempotent
        m = global_mesh()
        assert (m.size, m.rank, m.backend) == (1, 0, "gloo")
        m2 = host_chip_mesh()
        assert m2.shape == {"hosts": 1, "chips": 1}
        assert is_coordinator()
    finally:
        dist.destroy_process_group()


def test_two_process_dist_bench_matches_single(capsys):
    """``dist-bench`` as a job of one and then of two gloo processes (swe
    M=16, k=20, tol=1e-6): both print a ``DIST_RESULT`` line with the JAX
    package's keys, take the same steps and certify (deviation below
    1e-10); the spawner prints the efficiency table."""
    from structurepreservingiterativesolvers_torch.experiments.scaling import (
        dist_efficiency,
    )

    rows = dist_efficiency("swe", M=16, k=20, tol=1e-6, process_counts=(1, 2),
                           device="cpu")
    keys = {"problem", "M", "n", "nnz", "hosts", "devices", "spmv_time_s",
            "spmv_nnz_per_s", "collective_latency_s", "solve_time_s", "steps",
            "deviation", "safety"}
    r1, r2 = rows
    assert keys <= set(r1) and keys <= set(r2)
    assert (r1["devices"], r2["devices"], r2["hosts"]) == (1, 2, 2)
    assert r1["steps"] == r2["steps"]
    assert r1["safety"] is True and r2["safety"] is True
    assert r2["deviation"] < 1e-10
    np.testing.assert_allclose(r1["deviation"], r2["deviation"], atol=1e-10)
    table = capsys.readouterr().out
    assert table.count("DIST_RESULT {") == 2
    assert "| hosts | devices |" in table and "solve_efficiency" in table
