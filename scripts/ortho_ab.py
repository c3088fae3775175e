"""The walls of the device-core solves that run kernel #5 (the fused CGS2
update, ``csrc/ortho_fused.cu``) on the card, for the package found under
``--root``.

    python scripts/ortho_ab.py [--root DIR] [--out FILE]

``--root`` is the directory that holds the ``structurepreservingiterative
solvers_torch`` package to measure (default: this checkout), so that one
command can measure two versions of the port on the same card, each in a
process of its own: unpack the other version with ``git archive`` into a
directory that ``.gitignore`` lists and run parent, change, change, parent.
The script uses only the port's public entry points of every version.

It builds the kernel, then takes the median wall of 5 device-core CGMRES
solves with ``ortho="cgs2_fused"`` (after a capture): swe M=512,
unpreconditioned, k=60, tol=1e-9, and heat P2 M=512 with the greedy AMG,
k=60, tol=1e-7.  The kernel's own checks and times are ``chip_smoke.py``'s
phase 10.

Prints one JSON line a part, tagged with the root and the card's
``nvidia-smi`` name and power limit; ``--out`` appends them to a file.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def walls():
    import torch

    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.kernels import ortho
    from structurepreservingiterativesolvers_torch.models import heat, swe
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    out = {}
    for label, build, kw in (
            ("swe_M512_graph_core", lambda: swe.linforms(M=512, device="cuda"),
             dict(k=60, tol=1e-9, pre=None)),
            ("heat_P2_M512_graph_core",
             lambda: heat.linforms(M=512, degree=2, device="cuda"),
             dict(k=60, tol=1e-7))):
        s = build()
        if "pre" not in kw:
            kw = dict(kw, pre=default_pre_builder("heat")(s))

        def solve():
            x, info = cgmres(s.A, s.b, constraints=s.constraints(),
                             loop="while", ortho="cgs2_fused", **kw)
            torch.cuda.synchronize()
            return info

        info = solve()  # captures
        before = ortho.fused_update_matvec_cuda.launches
        ws = []
        for _ in range(5):
            t0 = time.perf_counter()
            info = solve()
            ws.append(1e3 * (time.perf_counter() - t0))
        out[label] = {
            "median_ms": statistics.median(ws), "walls_ms": ws,
            "steps": info["steps"], "safety": info["safety"],
            "launches_per_solve":
                (ortho.fused_update_matvec_cuda.launches - before) / 5}
        del s, kw
        torch.cuda.empty_cache()
    return out



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("ortho_ab.py needs a CUDA device")
    from structurepreservingiterativesolvers_torch.kernels import build

    t0 = time.perf_counter()
    _, log = build.build("ortho_fused.cu")
    head = {"root": args.root, "card": _card(),
            "build_s": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]}
    t0 = time.perf_counter()
    res = walls()
    lines = [{"part": "build", **head},
             {"part": "walls", "root": args.root, "card": head["card"],
              "seconds": time.perf_counter() - t0, **res}]
    for line in lines:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
