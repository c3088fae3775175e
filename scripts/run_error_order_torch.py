"""The convergence-order study on the PyTorch port → docs/CONVERGENCE_TORCH.md.

The port's twin of ``scripts/run_error_order.py`` (which runs the JAX
package on the CPU and writes ``docs/CONVERGENCE.md``).  It imports the
port only, runs on the card by default (``--device cpu`` for the CPU), and
solves every iterative step on the device core (``loop="while"``: CUDA
graphs on the card).  The claim it checks is the reference error
pipeline's (reference lkdvRK/ErrorGenerator.py:11-80 → ErrorPlotter.py):
CGMRES keeps Gauss–Legendre s-stage collocation's temporal order 2s while
it enforces the invariants.  Three sections, as in the JAX doc:

1. ``grid``: the reference grid (degree, stages, tol) ∈ {(3,2,1e-3),
   (4,3,1e-5), (5,4,1e-7)} at N=10, M=400, k=50 through
   ``experiments/error_sweep.py::run_sweep(loop="while")``; Exact, GMRES
   and CGMRES err(T).  Each Exact error is held to the JAX doc's printed
   value to its 4 digits, or, at the error functional's roundoff floor
   ((4, 3) and (5, 4)), within 1e-14 (``matches_printed``).
2. ``tight``: the order-resolving point (3, 2) at N=10, M=400, tol=1e-9;
   CGMRES/Exact < 2 is asserted.
3. ``refine``: dt-refinement at degree 5, M=120, tol=1e-11, s=1 over
   N = 4, 8, 16 and s=2 over N = 2, 4, 8; the observed order within 0.4 of
   2s for Exact and CGMRES and CGMRES ≤ 1.05 × Exact at every level (the
   JAX script's six checks); each Exact error held to the JAX doc's printed
   value, and at s=1, N = 4, 8 both errors to the JAX records
   (``reference/slice18.json``: Exact within 1e-9, CGMRES within 1e-6
   relative).

Each section prints its wall; the doc states the card's name and power
limit (``nvidia-smi``) beside every time.  A failed check is written into
the doc as FAILED and makes the exit code 1.

    python scripts/run_error_order_torch.py                  # every section, on the card
    python scripts/run_error_order_torch.py refine --device cpu --out build/CONVERGENCE_TORCH.md
    python scripts/run_error_order_torch.py grid --out build/CONVERGENCE_TORCH.md

The grid's nine evolutions run one after another in this process
(``run_sweep(parallel=False)``: the kernels are built once), their pickles
in ``tmp/``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

OUT = ROOT / "docs" / "CONVERGENCE_TORCH.md"
JAX_DOC = ROOT / "docs" / "CONVERGENCE.md"
RECORD = (ROOT / "structurepreservingiterativesolvers_torch" / "reference"
          / "slice18.json")
TIGHT_TOL = 1e-9
REFINE = dict(M=120, degree=5, tol=1e-11)
REFINE_NS = ((1, (4, 8, 16)), (2, (2, 4, 8)))
ORDER_SLACK, TRACK = 0.4, 1.05
# the records' bars: the direct solve's error (the same discrete problem)
# and CGMRES's (a solve to tol=1e-11)
EXACT_RTOL, CGMRES_RTOL = 1e-9, 1e-6
# an Exact error below FLOOR_ERR sits at the roundoff floor of the error
# functional (the JAX doc says so of (4, 3) and (5, 4): 5.2e-13, 1.0e-12),
# where its digits are roundoff (the card and the CPU differ by 1e-15
# there); it is held to the JAX value within FLOOR_ATOL, not to 4 digits
FLOOR_ERR, FLOOR_ATOL = 1e-11, 1e-14

GRID_M = "## Reference grid (N=10"
TIGHT_M = "## Reference grid at an order-resolving tolerance"
REFINE_M = "## dt-refinement"


def final_error(solver, N, tstages, M=120, degree=5, tol=1e-11, k=50,
                loop="while", *, device):
    """One lkdvRK evolution to T=1 on ``device`` (the JAX script's ``run``):
    the direct solve (``Exact``), or GMRES or CGMRES through their wrappers
    on ``loop`` with the TimedSolve pre-builder's RAS + Neumann composite
    built on the first system.  Returns err(T) and ``evolve``'s output."""
    from structurepreservingiterativesolvers_torch.experiments import (
        wrappers,
    )
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import lkdvrk

    if solver == "Exact":
        def fn(system, x0=None, k=k, tol=tol, pre=None):
            return wrappers.exact(system)[0], {"steps": -1}
        pre = None
    else:
        s0 = lkdvrk.linforms(N=N, M=M, degree=degree, tstages=tstages, T=1.0,
                             device=device)
        pre = default_pre_builder("lkdvrk")(s0)
        fn = functools.partial({"GMRES": wrappers.gmres_wrapper,
                                "CGMRES": wrappers.cgmres_wrapper}[solver],
                               loop=loop)
    out = evolve("lkdvrk", N=N, M=M, degree=degree, tstages=tstages, T=1.0,
                 k=k, tol=tol, solver=fn, pre=pre, compute_error=True,
                 device=device)
    return float(out["err"][-1]), out


def observed_orders(errs):
    """log2(err(N) / err(2N)) between successive levels."""
    return [math.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]


def jax_printed():
    """The JAX doc's printed errors: ``grid`` {(degree, stages): (Exact,
    GMRES, CGMRES)}, ``tight`` (Exact, GMRES, CGMRES) and ``refine``
    {(stages, solver): [errors over N]}."""
    text = JAX_DOC.read_text()
    num = r"([0-9.]+e[-+][0-9]+)"
    grid, tight = {}, None
    for m in re.finditer(rf"^\| (\d) \| (\d) \| ([0-9.e-]+) \| {num} \| {num} "
                         rf"\| {num} \|", text, re.M):
        vals = tuple(float(v) for v in m.groups()[3:])
        if float(m.group(3)) == TIGHT_TOL:
            tight = vals
        else:
            grid[(int(m.group(1)), int(m.group(2)))] = vals
    refine = {}
    for m in re.finditer(r"^\| (\d) \| (Exact|CGMRES) \| ([0-9.e, -]+) \|",
                         text, re.M):
        refine[(int(m.group(1)), m.group(2))] = [
            float(v) for v in m.group(3).split(",")]
    return {"grid": grid, "tight": tight, "refine": refine}


def matches_printed(value, printed):
    """``value`` agrees with the JAX doc's 4-digit ``printed`` value to its
    4 digits: within one unit of its last digit (the printed value's own
    rounding, half a unit, and half a unit of agreement); at the error
    functional's roundoff floor (below ``FLOOR_ERR``) within
    ``FLOOR_ATOL``."""
    if printed < FLOOR_ERR:
        return abs(value - printed) <= FLOOR_ATOL
    unit = 10.0 ** (math.floor(math.log10(abs(printed))) - 3)
    return abs(value - printed) <= unit * (1 + 1e-9)


def agreement(printed):
    """How ``matches_printed`` holds a value to ``printed``, for the doc."""
    if printed < FLOOR_ERR:
        return (f"within {FLOOR_ATOL:g} (the roundoff floor of the error "
                "functional)")
    return "to its 4 digits"


class Checks:
    """The study's checks: each a line of the doc, PASSED or FAILED."""

    def __init__(self):
        self.lines, self.failed = [], 0

    def __call__(self, ok, what):
        self.lines.append(f"- {'passed' if ok else 'FAILED'}: {what}")
        self.failed += not ok
        print(("[ok] " if ok else "[FAILED] ") + what, flush=True)
        return ok

    def block(self, start):
        return "\n".join(self.lines[start:])


def card(device):
    """The device's name and power limit, as nvidia-smi gives them on the
    card; the CPU otherwise."""
    if str(device).startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    import platform

    return f"CPU ({platform.machine()}, no card)"


def grid_section(device, where, checks):
    from structurepreservingiterativesolvers_torch.experiments.error_sweep import (
        DEFAULT_GRID,
        run_sweep,
    )

    start = len(checks.lines)
    printed = jax_printed()["grid"]
    t0 = time.perf_counter()
    merged = run_sweep(parallel=False, tmpdir=str(ROOT / "tmp"), loop="while",
                       device=device)
    wall = time.perf_counter() - t0
    rows = {(d["solver"], d["degree"], d["tstages"]): d for d in merged}
    lines = [
        "## Reference grid (N=10, M=400, k=50 — "
        "reference ErrorGenerator.py:16-34)\n",
        "| degree | stages | tol | Exact err(T) | GMRES err(T) | "
        "CGMRES err(T) | CGMRES/Exact | JAX Exact (docs/CONVERGENCE.md) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for degree, tstages, tol in DEFAULT_GRID:
        try:
            e, g, c = (rows[(s, degree, tstages)]["err"][-1]
                       for s in ("Exact", "GMRES", "CGMRES"))
        except KeyError:
            lines.append(f"| {degree} | {tstages} | {tol:g} | (failed) | | | | |")
            checks(False, f"grid ({degree}, {tstages}): a run failed")
            continue
        e, g, c = float(e), float(g), float(c)
        ratio = (f"{c / e:.2f}" if e > 0.1 * tol
                 else f"{c / e:.2g} (tol-limited: exact err ≪ tol)")
        ej = printed[(degree, tstages)][0]
        lines.append(f"| {degree} | {tstages} | {tol:g} | {e:.6e} | {g:.3e} "
                     f"| {c:.3e} | {ratio} | {ej:.3e} |")
        checks(matches_printed(e, ej),
               f"grid ({degree}, {tstages}) Exact err(T) {e:.6e} agrees with "
               f"the JAX doc's {ej:.3e} {agreement(ej)}")
    lines += [
        "",
        "The iterative-solver errors sit at max(discretisation error, "
        "solver-tolerance error): the grid pairs loose tolerances with high "
        "orders as the reference does, so at (4, 3) and (5, 4) they are "
        "tolerance-limited and a ratio to Exact certifies nothing; the two "
        "sections below isolate the order claim. There the Exact error "
        "itself sits at the roundoff floor of the error functional, so its "
        "digits are roundoff: it is held to the JAX run's within "
        f"{FLOOR_ATOL:g}, the others to their 4 printed digits.",
        "",
        "The nine evolutions ran one after another in one process "
        "(`run_sweep(parallel=False)`), every GMRES and CGMRES step on the "
        f"device core. Grid wall {wall:.1f} s on {where}.",
        "",
        checks.block(start),
    ]
    print(f"[grid] wall {wall:.1f} s on {where}", flush=True)
    return "\n".join(lines) + "\n"


def tight_section(device, where, checks):
    start = len(checks.lines)
    printed = jax_printed()["tight"]
    t0 = time.perf_counter()
    res = {solver: final_error(solver, 10, 2, M=400, degree=3, tol=TIGHT_TOL,
                               device=device)[0]
           for solver in ("Exact", "GMRES", "CGMRES")}
    wall = time.perf_counter() - t0
    e, g, c = res["Exact"], res["GMRES"], res["CGMRES"]
    checks(c / e < 2.0, f"(3, 2) at tol={TIGHT_TOL:g}: CGMRES/Exact "
                        f"{c / e:.6f} < 2 (JAX doc {printed[2] / printed[0]:.3f})")
    checks(matches_printed(e, printed[0]),
           f"(3, 2) Exact err(T) {e:.6e} agrees with the JAX doc's "
           f"{printed[0]:.3e} {agreement(printed[0])}")
    lines = [
        "## Reference grid at an order-resolving tolerance\n",
        "The one reference grid point where the discretisation error "
        "dominates, (3, 2), re-run at a tolerance below that error: CGMRES "
        "must track Exact directly.\n",
        "| degree | stages | tol | Exact err(T) | GMRES err(T) | "
        "CGMRES err(T) | CGMRES/Exact | GMRES/Exact |",
        "|---|---|---|---|---|---|---|---|",
        f"| 3 | 2 | {TIGHT_TOL:g} | {e:.6e} | {g:.6e} | {c:.6e} | "
        f"{c / e:.6f} | {g / e:.6f} |",
        "",
        f"Wall {wall:.1f} s on {where} (three evolutions of 10 steps at "
        "M=400, the composite built twice).",
        "",
        checks.block(start),
    ]
    print(f"[tight] wall {wall:.1f} s on {where}", flush=True)
    return "\n".join(lines) + "\n"


def refinement_section(device, where, checks):
    start = len(checks.lines)
    printed = jax_printed()["refine"]
    record = json.loads(RECORD.read_text())["order_deg5_s1_M120"]["runs"]
    t0 = time.perf_counter()
    summary = {}
    for tstages, Ns in REFINE_NS:
        for solver in ("Exact", "CGMRES"):
            errs = [final_error(solver, N, tstages, device=device, **REFINE)[0]
                    for N in Ns]
            summary[(tstages, solver)] = (errs, observed_orders(errs))
    wall = time.perf_counter() - t0
    lines = [
        "## dt-refinement: observed temporal order (degree=5, M=120, "
        "tol=1e-11)\n",
        "GL s-stage collocation is order 2s; the observed order is "
        "log2(err(N)/err(2N)).\n",
        "| stages | solver | errors over N | observed orders | expected | "
        "JAX errors (docs/CONVERGENCE.md) |",
        "|---|---|---|---|---|---|",
    ]
    for (tstages, solver), (errs, orders) in summary.items():
        lines.append(
            f"| {tstages} | {solver} | "
            + ", ".join(f"{e:.6e}" for e in errs) + " | "
            + ", ".join(f"{o:.4f}" for o in orders)
            + f" | {2 * tstages} | "
            + ", ".join(f"{e:.3e}" for e in printed[(tstages, solver)]) + " |")
    lines.append("")
    six = 0
    for tstages, Ns in REFINE_NS:
        exp = 2 * tstages
        for solver in ("Exact", "CGMRES"):
            _, orders = summary[(tstages, solver)]
            six += checks(abs(orders[0] - exp) < ORDER_SLACK,
                          f"s={tstages} {solver}: observed order "
                          f"{orders[0]:.4f} within {ORDER_SLACK} of {exp}")
        ee, ce = summary[(tstages, "Exact")][0], summary[(tstages, "CGMRES")][0]
        ratio = max(c / e for c, e in zip(ce, ee))
        six += checks(ratio < TRACK, f"s={tstages}: CGMRES/Exact at most "
                                     f"{ratio:.6f} < {TRACK} over N = "
                                     f"{', '.join(map(str, Ns))}")
    for tstages, Ns in REFINE_NS:
        ej = printed[(tstages, "Exact")]
        for N, e, p in zip(Ns, summary[(tstages, "Exact")][0], ej):
            checks(matches_printed(e, p), f"s={tstages} N={N} Exact {e:.6e} "
                                          f"agrees with the JAX doc's {p:.3e} "
                                          f"{agreement(p)}")
    ee, ce = summary[(1, "Exact")][0], summary[(1, "CGMRES")][0]
    for i, N in enumerate(REFINE_NS[0][1][:2]):
        je, jc = (record[f"{s}_N{N}"]["err"][-1] for s in ("Exact", "CGMRES"))
        checks(abs(ee[i] - je) <= EXACT_RTOL * je and
               abs(ce[i] - jc) <= CGMRES_RTOL * jc,
               f"s=1 N={N}: Exact {abs(ee[i] - je) / je:.2e} and CGMRES "
               f"{abs(ce[i] - jc) / jc:.2e} relative from the JAX record "
               f"(reference/slice18.json; bars {EXACT_RTOL:g}, {CGMRES_RTOL:g})")
    lines += [
        f"The JAX script's six checks: {six} of 6 passed. Wall {wall:.1f} s on "
        f"{where} (twelve evolutions; CGMRES on the device core).",
        "",
        checks.block(start),
    ]
    print(f"[refine] wall {wall:.1f} s on {where}", flush=True)
    return "\n".join(lines) + "\n"


def _existing(out: Path, marker: str):
    """A section of the doc as it stands (from ``marker`` to the next
    '## ' or the end), or None."""
    if not out.exists():
        return None
    body = out.read_text()
    if marker not in body:
        return None
    tail = body.split(marker, 1)[1]
    nxt = tail.find("\n## ")
    return marker + (tail if nxt < 0 else tail[: nxt + 1])


def header(device, where):
    import torch

    return (
        "# Convergence-order evidence on the PyTorch port (lkdvRK error "
        "pipeline)\n\n"
        "The port's run of the study in `docs/CONVERGENCE.md` (the JAX "
        "package on the CPU): **CGMRES keeps the discretisation's temporal "
        "order while it enforces the invariants**. Every GMRES and CGMRES "
        "step ran on the device core (`loop=\"while\"`, CUDA graphs on the "
        "card), with the TimedSolve pre-builder's RAS + Neumann composite, "
        "warm-started, in f64; the Exact solves are scipy's direct solve on "
        "the host. Generated by `scripts/run_error_order_torch.py`.\n\n"
        f"Device: {device}, {where}; torch {torch.__version__}"
        + (f", CUDA {torch.version.cuda}" if str(device).startswith("cuda")
           else "")
        + ".\n\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all", "grid", "tight", "refine"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    out = Path(args.out)
    where = card(args.device)
    checks = Checks()
    t0 = time.perf_counter()
    sections = {m: _existing(out, m) for m in (GRID_M, TIGHT_M, REFINE_M)}
    if args.which in ("all", "grid"):
        sections[GRID_M] = grid_section(args.device, where, checks)
    if args.which in ("all", "tight"):
        sections[TIGHT_M] = tight_section(args.device, where, checks)
    if args.which in ("all", "refine"):
        sections[REFINE_M] = refinement_section(args.device, where, checks)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(header(args.device, where)
                   + "\n".join(s for s in sections.values() if s))
    print(f"wrote {out}; {len(checks.lines) - checks.failed} checks passed, "
          f"{checks.failed} failed; {time.perf_counter() - t0:.1f} s on "
          f"{where}", flush=True)
    return 1 if checks.failed else 0


if __name__ == "__main__":
    sys.exit(main())
