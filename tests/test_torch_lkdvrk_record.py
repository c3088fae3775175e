"""The port's lkdvRK TimedSolve row, evolution and error sweep at M=50
against the JAX package's record (``reference/slice7.json``, written by
``scripts/make_torch_reference.py``), in f64 on the CPU; and the sweep's
process fan-out, its merge and its plot.

Bars: the format of A, its width and the RAS block shape equal; steps and
constrained steps within one, the same safety, a KKT deviation of at most
1e-10; the per-step L2 errors of an evolution within max(1e-8, 10× the
evolution's own drift under a 1e-15 relative perturbation of each step's
b) relative of the record's, and its mass drift at most 1e-9.  At degree
2, tol=1e-7 that own drift is about 1e-7: each CGMRES solve stops four or
five steps in, and the next step's system is built from its iterate.
"""

import importlib
import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.experiments import error_sweep
from structurepreservingiterativesolvers_torch.experiments import wrappers
from structurepreservingiterativesolvers_torch.experiments.evolve import evolve
from structurepreservingiterativesolvers_torch.models import lkdvrk

# the module (the experiments package exports a function of the same name,
# as the JAX package's does)
tts = importlib.import_module(
    "structurepreservingiterativesolvers_torch.experiments.timed_solve")

RECORD = torch_parity.slice7()
check_runs = torch_parity.check_lkdvrk_runs


def test_timed_row_matches_jax_record():
    torch_parity.check_lkdvrk_row("lkdvrk_M50_deg3_s2")


def test_evolve_matches_jax_record(tmp_path):
    """One grid row's preconditioned CGMRES evolution, N=10, M=50."""
    cfg = RECORD["lkdvrk_M50_deg3_s2_evolve"]["config"]
    (degree, tstages, tol), = cfg["grid"]
    out = error_sweep.run_single("CGMRES", degree, tstages, tol, N=cfg["N"],
                                 M=cfg["M"], k=cfg["k"], tmpdir=str(tmp_path),
                                 device="cpu")
    check_runs([out], "lkdvrk_M50_deg3_s2_evolve")


def test_error_sweep_serial_matches_jax_record(tmp_path):
    """The configuration of tests/test_experiments.py::
    test_error_sweep_serial: the merged pickle is written, each run matches
    the record, and CGMRES tracks the exact solver's error."""
    cfg = RECORD["lkdvrk_M50_sweep"]["config"]
    merged = error_sweep.run_sweep(
        grid=[tuple(g) for g in cfg["grid"]], solvers=tuple(cfg["solvers"]),
        N=cfg["N"], M=cfg["M"], k=cfg["k"], tmpdir=str(tmp_path), device="cpu")
    check_runs(merged, "lkdvrk_M50_sweep")
    with open(tmp_path / "error.pickle", "rb") as fh:
        assert len(pickle.load(fh)) == 2
    exact, cg = (next(m for m in merged if m["solver"] == s)
                 for s in ("Exact", "CGMRES"))
    assert cg["err"][-1] < 5 * exact["err"][-1] + 1e-4


def test_error_sweep_fanout_skips_failed_runs(tmp_path, monkeypatch):
    """Worker processes on the CPU, two at a time; a run that fails (an
    unknown solver) is left out of the merge."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the suite runs side by side
    merged = error_sweep.run_sweep(
        grid=[(1, 1, 1e-6)], solvers=("Exact", "CGMRES", "Unknown"), N=2,
        M=30, k=40, tmpdir=str(tmp_path), parallel=True, max_processes=2,
        device="cpu")
    assert sorted(m["solver"] for m in merged) == ["CGMRES", "Exact"]
    assert all(len(m["err"]) == 3 for m in merged)


def test_error_plot_needs_matplotlib(tmp_path, monkeypatch):
    with open(tmp_path / "error.pickle", "wb") as fh:
        pickle.dump([], fh)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        error_sweep.error_plot(str(tmp_path),
                               filename=os.path.join(tmp_path, "e.pdf"))
