"""Reporting helpers (the JAX package's ``experiments/report.py``).

Only the invariant targets are ported so far; the tabulator and the plots
come later.
"""

from __future__ import annotations


def _targets(system, names):
    """The invariant targets of ``system`` for invariant ``names``."""
    out = {}
    for k in names:
        attr = {"mass": "m0", "momentum": "mo0", "energy": "e0"}[k]
        out[k] = float(getattr(system, attr))
    return out
