"""The reporting of the PyTorch port against the JAX package's, on the CPU in
f64: ``report.tabulator`` (its columns equal and its values within 1e-10 of
the JAX tabulator on the same lkdv M=20 system, and of the record
``reference/slice13.json``; the ``.tex`` and ``.csv`` written), the two
figures, ``single_solve(plot=True, pre="auto")`` on lkdvRK M=20 held to the
record, ``deviation_plotter``'s figure and the command line's ``--plot``.
pandas and matplotlib are optional in the port: the tests that draw skip
without matplotlib.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.experiments import report
from structurepreservingiterativesolvers_torch.experiments import wrappers

REC = json.loads((torch_parity.ROOT / "structurepreservingiterativesolvers_torch"
                  / "reference" / "slice13.json").read_text())


def _lkdv_runs(k=10):
    """lkdv M=20 (degree 1) in both packages, GMRES and the prototypical
    CGMRES with history from zeros: (JAX system, its runs, port system, its
    runs)."""
    from structurepreservingiterativesolvers_tpu.experiments import (
        wrappers as jwrappers,
    )
    from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv

    cfg = REC["lkdv_M20_table"]["config"]
    js = jlkdv.linforms(M=cfg["M"], degree=cfg["degree"])
    ts = torch_parity.to_port(js)
    jkw = dict(x0=jnp.zeros_like(js.b), k=k, tol=1e-50, history=True)
    tkw = dict(x0=torch.zeros_like(ts.b), k=k, tol=1e-50, history=True)
    jruns = [jwrappers.gmres_wrapper(js, **jkw)[1],
             jwrappers.cgmres_wrapper(js, **jkw)[1]]
    truns = [wrappers.gmres_wrapper(ts, **tkw)[1],
             wrappers.cgmres_wrapper(ts, **tkw)[1]]
    return js, jruns, ts, truns


def test_tabulator_matches_jax_and_record():
    pytest.importorskip("pandas")
    from structurepreservingiterativesolvers_tpu.experiments import (
        report as jreport,
    )

    js, jruns, ts, truns = _lkdv_runs()
    jt, tt = jreport.tabulator(js, jruns), report.tabulator(ts, truns)
    assert tt["names"] == jt["names"] == ["gmres", "geosolve"]
    assert list(tt["df"].columns) == list(jt["df"].columns)
    rec = REC["lkdv_M20_table"]
    assert list(tt["df"].columns) == rec["columns"]
    for col in rec["columns"]:
        a = tt["df"][col].to_numpy()
        for ref in (jt["df"][col].to_numpy(), np.asarray(rec["values"][col])):
            assert a.shape == ref.shape
            scale = 1.0 if "deviation" in col else float(np.abs(ref).max())
            assert float(np.abs(a - ref).max()) <= 1e-10 * scale, col


def test_tabulator_writes_tex_and_csv(tmp_path, capsys):
    pd = pytest.importorskip("pandas")
    _, _, ts, truns = _lkdv_runs(k=4)
    out = report.tabulator(ts, truns, filename=str(tmp_path / "table"),
                           print_table=True)
    assert "gmres residual norm" in capsys.readouterr().out
    assert (tmp_path / "table.tex").read_text().startswith("\\begin{tabular}")
    back = pd.read_csv(tmp_path / "table.csv")
    assert list(back.columns) == list(out["df"].columns)
    np.testing.assert_allclose(back.to_numpy(), out["df"].to_numpy(),
                               rtol=1e-12)


def test_convergence_and_deviation_plots_write_files(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    _, _, ts, truns = _lkdv_runs(k=4)
    table = report.tabulator(ts, truns)
    path = report.convergence_plot(table, filename=str(tmp_path / "c.pdf"),
                                   title="lkdv")
    assert path == str(tmp_path / "c.pdf") and (tmp_path / "c.pdf").stat().st_size
    runs = {"GMRES": {"time": np.arange(1, 4) * 0.1, "dm": np.full(3, 1e-9),
                      "de": np.full(3, 1e-8)},
            "CGMRES": {"time": np.arange(1, 4) * 0.1, "dm": np.zeros(3),
                       "de": np.full(3, 1e-15)}}
    monkeypatch.chdir(tmp_path)
    path = report.deviation_plot(runs)
    assert path == str(tmp_path / "plots" / "evolve.pdf")
    assert (tmp_path / "plots" / "evolve.pdf").stat().st_size


def test_single_solve_plot_and_pre_auto_match_record(tmp_path, monkeypatch):
    """``single_solve("lkdvrk", M=20, pre="auto", plot=True)``: the
    element-block preconditioner, as the JAX package's; GMRES's error,
    every deviation and the steps as the record's, CGMRES's iterate within
    10× the JAX package's own drift of it (the prototypical CGMRES
    stagnates near a residual of 5e-5 with this preconditioner, where a
    change of b at the rounding level moves its iterate by percents); the
    table and the figure written."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    from structurepreservingiterativesolvers_torch.experiments.single_solve import (
        single_solve,
    )
    from structurepreservingiterativesolvers_torch.models import lkdvrk

    built = []
    make = lkdvrk.element_block_preconditioner
    monkeypatch.setattr(lkdvrk, "element_block_preconditioner",
                        lambda system: built.append(make(system)) or built[-1])
    rec = REC["lkdvrk_M20_single_auto"]
    out = single_solve("lkdvrk", M=rec["config"]["M"], pre="auto", plot=True,
                       filename=str(tmp_path / "rk"), verbose=False,
                       device="cpu")
    assert len(built) == 1
    assert out["gmres_error"] == pytest.approx(rec["gmres_error"], abs=1e-10)
    assert {lbl: out[lbl][1]["steps"] for lbl in ("gmres", "cgmres")} == \
        rec["steps"]
    for label, devs in rec["deviations"].items():
        for inv, d in devs.items():
            assert abs(out["deviations"][label][inv] - d) <= 1e-12, (label, inv)
    for label in ("gmres", "cgmres"):
        torch_parity.close(out[label][0].numpy(), rec["x"][label],
                           max(1e-10, 10.0 * rec["own_drift"][label]))
    assert list(out["table"]["df"].columns)[0] == "gmres residual norm"
    for ext in ("tex", "csv", "pdf"):
        assert (tmp_path / f"rk.{ext}").stat().st_size
    # pre="auto" is no preconditioner for the other problems
    a = single_solve("lkdv", M=20, k=5, pre="auto", verbose=False,
                     device="cpu")
    b = single_solve("lkdv", M=20, k=5, verbose=False, device="cpu")
    assert torch.equal(a["cgmres"][0], b["cgmres"][0])


def test_cli_plot_and_deviation_plotter(tmp_path, monkeypatch):
    """``single --plot`` and ``evolve --plot`` write their figures under
    ``plots/``; ``deviation_plotter`` returns its figure's path with both
    evolutions."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    from structurepreservingiterativesolvers_torch.experiments.cli import main
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        deviation_plotter,
    )

    monkeypatch.chdir(tmp_path)
    main(["single", "--problem", "lkdv", "--M", "20", "--k", "5", "--plot",
          "--device", "cpu"])
    assert (tmp_path / "plots" / "convergence.pdf").stat().st_size
    main(["evolve", "--problem", "lkdv", "--M", "20", "--N", "2", "--k", "20",
          "--plot", "--device", "cpu"])
    assert (tmp_path / "plots" / "evolve.pdf").stat().st_size
    out = deviation_plotter("lkdv", N=2, M=20, k=20, filename=str(
        tmp_path / "d.pdf"), device="cpu")
    assert out["figure"] == str(tmp_path / "d.pdf")
    assert set(out) == {"GMRES", "CGMRES", "figure"}
    assert len(out["CGMRES"]["dm"]) == 3 and max(out["CGMRES"]["dm"]) <= 1e-10
