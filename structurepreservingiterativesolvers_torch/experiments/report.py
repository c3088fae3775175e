"""Tabulation and plotting (the JAX package's ``experiments/report.py``;
parity with the reference ``visualise.py`` modules and Evolve's
DeviationPlotter).

``tabulator`` builds a per-iteration DataFrame of residual norms and
invariant deviations per solver (reference lkdv/visualise.py:13-59),
optionally writing ``.tex``/``.csv``; ``convergence_plot`` renders the
log-scale comparison figure (lkdv/visualise.py:63-112);
``deviation_plot`` renders invariant drift over a time evolution
(lkdv/Evolve.py:70-114).  pandas and matplotlib are optional: each is
imported inside the function that needs it, so nothing else of the port
needs them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _deviations(system, xs):
    """Per-iterate invariant deviations.  xs[0] is the initial residual
    vector (reference quirk) — iterate from index 1
    (lkdv/visualise.py:28)."""
    names = None
    rows = []
    for j in range(1, len(xs)):
        inv = system.compute_invariants(xs[j])
        if names is None:
            names = list(inv.keys())
        targets = _targets(system, names)
        rows.append([float(inv[k]) - targets[k] for k in names])
    return names or [], np.asarray(rows)


def _targets(system, names):
    """The invariant targets of ``system`` for invariant ``names``."""
    out = {}
    for k in names:
        attr = {"mass": "m0", "momentum": "mo0", "energy": "e0"}[k]
        out[k] = float(getattr(system, attr))
    return out


def tabulator(system, dict_list: List[dict], filename: Optional[str] = None,
              print_table: bool = False):
    """DataFrame of residuals + invariant deviations for each solver run.

    Each entry of ``dict_list`` is a solver info dict with history
    (``history=True`` runs)."""
    import pandas as pd

    df = pd.DataFrame()
    names = []
    for data in dict_list:
        name = data["name"]
        names.append(name)
        df = pd.concat(
            [df, pd.DataFrame({f"{name} residual norm": data["res"]})],
            axis=1,
        )
        inv_names, devs = _deviations(system, data["x"])
        for i, inv in enumerate(inv_names):
            df = pd.concat(
                [df, pd.DataFrame({f"{name} {inv} deviation": devs[:, i]})],
                axis=1,
            )
    if filename is not None:
        with open(filename + ".tex", "w") as fh:
            fh.write(df.to_latex(index=False))
        df.to_csv(filename + ".csv", index=False)
    if print_table:
        with pd.option_context("display.max_rows", None,
                               "display.max_columns", None,
                               "display.width", None):
            print(df)
    return {"df": df, "names": names}


def _ensure_plots_dir(path: Optional[str]) -> str:
    d = path or os.path.join(os.getcwd(), "plots")
    os.makedirs(d, exist_ok=True)
    return d


def convergence_plot(vis_out, filename: Optional[str] = None, title: str = ""):
    """Log-scale residual + deviation comparison across solvers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = vis_out["df"]
    names = vis_out["names"]
    colors = ["r", "b", "k", "g"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for name, c in zip(names, colors):
        ax.plot(df[f"{name} residual norm"], c + "-", lw=2,
                label=f"{name}: residual")
        styles = iter([":", "-.", "--", "-"])
        for col in df.columns:
            if col.startswith(name) and col.endswith("deviation"):
                ax.plot(np.abs(df[col]) + 1e-16, c + next(styles), lw=2,
                        label=f"{name}: {col.split(' ', 1)[1]}")
    ax.set_yscale("log")
    ax.set_xlabel("Iteration number")
    ax.grid(which="both", linestyle="--", axis="y")
    ax.legend(loc="best", ncol=2, fontsize="small")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    out = filename or os.path.join(_ensure_plots_dir(None), "convergence.pdf")
    fig.savefig(out)
    plt.close(fig)
    print(f"Figure saved as {out}")
    return out


def deviation_plot(runs: dict, filename: Optional[str] = None):
    """Invariant drift over time for multiple evolve runs
    (reference DeviationPlotter, lkdv/Evolve.py:70-114).

    ``runs`` maps a label (e.g. 'GMRES'/'CGMRES') to an evolve output dict
    with keys ``time`` and per-invariant drift arrays (``dm``/``dmo``/``de``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    styles = {"dm": ("dotted", "Mass"), "dmo": ("dashdot", "Momentum"),
              "de": ("dashed", "Energy")}
    colors = ["r", "b", "k", "g"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for (label, out), c in zip(runs.items(), colors):
        for key, (ls, inv) in styles.items():
            if key in out and len(out[key]):
                ax.semilogy(out["time"], np.maximum(out[key], 1e-18),
                            color=c, linestyle=ls, lw=2,
                            label=f"{label}: {inv} deviation")
    ax.grid(which="major", linestyle="--", axis="y")
    ax.set_xlabel("t")
    ax.legend(loc="best", ncol=2, fontsize="small")
    fig.tight_layout()
    out_path = filename or os.path.join(_ensure_plots_dir(None), "evolve.pdf")
    fig.savefig(out_path)
    plt.close(fig)
    print(f"Figure saved as {out_path}")
    return out_path
