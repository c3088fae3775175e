"""Where a solve of the PyTorch port spends its time on the card: one GMRES
and one CGMRES solve under ``torch.profiler``, after an untimed warm-up
pass, on the slice's configurations:

* ``swe``: M=512, f64, k=60, tol=1e-9, unpreconditioned, or with
  ``--pre snc`` the TimedSolve row (k=20, tol=1e-7) with the skew-normal
  Chebyshev of the swe pre-builder, each apply 2·degree + 1 launches of the
  DIA kernel;
* ``heat``: M=1024, f64, k=20, tol=1e-7, with the structured AMG of the
  TimedSolve pre-builder, or with ``--pre cheb8`` / ``--pre neu4`` the
  polynomial pre-builders ``chebyshev(A, degree=8)`` /
  ``neumann(A, degree=4)``, each apply one launch of the fused kernel (its
  tiled design on heat's stencil).

``--ortho cgs2_fused`` runs the Arnoldi orthogonalisation's middle pair
through the fused CGS2 kernel (default ``cgs2``, four cuBLAS products).

    python scripts/profile_torch.py --problem heat [--pre amg|cheb8|neu4] [--M 1024] [--out build/profile]
    python scripts/profile_torch.py --problem swe [--pre none|snc] [--ortho cgs2|cgs2_fused]

Prints the busiest device kernels, the device-busy time against the wall
time of each solve (the device's idle share), the device time by kind
(stencil kernel, DIA kernel, fused polynomial kernels by design,
matrix-vector products of the Krylov basis and the coarse solve, the rest)
and, for heat, the device and host time spent inside the preconditioner's
applies; writes a Chrome trace per solver into ``--out``.  Then times one
preconditioner apply and one operator product alone with CUDA events.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CONFIGS = {"swe": dict(M=512, k=60, tol=1e-9), "heat": dict(M=1024, k=20, tol=1e-7)}
# the swe TimedSolve row with its preconditioner
SNC_CONFIG = dict(M=512, k=20, tol=1e-7)
# the profiler range around each preconditioner apply, per --pre
PRE_RANGES = {"amg": "amg_vcycle", "cheb8": "chebyshev_apply",
              "neu4": "neumann_apply", "snc": "skew_normal_chebyshev_apply"}
# the preconditioners of each problem; the first is the default
PRES = {"swe": ("none", "snc"), "heat": ("amg", "cheb8", "neu4")}


def _kind(name: str) -> str:
    if "stencil_spmv_kernel" in name:
        return "stencil kernel"
    if "dia_spmv_kernel" in name:
        return "DIA kernel"
    if "tiled_kernel" in name:
        return "fused polynomial kernel, tiled"
    if "cheb_kernel" in name or "neumann_kernel" in name:
        return "fused polynomial kernel, flat"
    if "fused_update_matvec_kernel" in name or "sum_partials_kernel" in name:
        return "fused CGS2 kernel"
    if "gemv" in name or "gemm" in name or "dot_kernel" in name:
        return "matrix-vector products (cuBLAS)"
    return "elementwise, norms, copies"


def _event_ms(fn, reps=100):
    import torch

    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=sorted(CONFIGS), default="heat")
    ap.add_argument("--pre", choices=["none", *sorted(PRE_RANGES)],
                    default=None,
                    help="the preconditioner (default: none for swe, the "
                         "AMG for heat)")
    ap.add_argument("--ortho", choices=["cgs2", "cgs2_fused"], default="cgs2")
    ap.add_argument("--M", type=int, default=None)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    args.pre = args.pre or PRES[args.problem][0]
    if args.pre not in PRES[args.problem]:
        ap.error(f"--pre {args.pre} is not a preconditioner of {args.problem}")

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.single_solve import (
        get_model,
    )

    cfg = dict(SNC_CONFIG if args.pre == "snc" else CONFIGS[args.problem])
    M = args.M or cfg["M"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    s = get_model(args.problem).linforms(M=M, device="cuda")
    pre = apply = None
    span = PRE_RANGES.get(args.pre)
    if args.pre != "none":
        from structurepreservingiterativesolvers_torch import precond
        from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
            default_pre_builder,
        )

        apply = {"amg": lambda: default_pre_builder("heat")(s),
                 "snc": lambda: default_pre_builder("swe")(s),
                 "cheb8": lambda: precond.chebyshev(s.A, degree=8),
                 "neu4": lambda: precond.neumann(s.A, degree=4)}[args.pre]()

        def pre(v):
            with record_function(span):
                return apply(v)

    kw = dict(k=cfg["k"], tol=cfg["tol"], pre=pre, ortho=args.ortho)
    solves = {
        "gmres": lambda: wrappers.gmres_wrapper(s, **kw),
        "cgmres": lambda: wrappers.cgmres_wrapper(s, **kw),
    }
    for fn in solves.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name, fn in solves.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, info = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key != span]
        busy_us = sum(e.self_device_time_total for e in kernels)
        label = f"{args.problem} --pre {args.pre} --ortho {args.ortho}"
        print(f"\n== {label} {name} M={M}: steps {info['steps']}, wall "
              f"{wall * 1e3:.3f} ms (profiled), device busy {busy_us / 1e3:.3f} "
              f"ms -> idle share {1 - busy_us / 1e6 / wall:.3f}")
        by_kind = {}
        for e in kernels:
            k = _kind(e.key)
            by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total
        for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"   {k}: {us / 1e3:.3f} ms ({us / busy_us:.1%} of device "
                  f"busy)")
        for e in events:
            if e.key == span:
                print(f"   inside {span} ({e.device_type}): {e.count} calls, "
                      f"device {e.device_time_total / 1e3:.3f} ms, host "
                      f"{e.cpu_time_total / 1e3:.3f} ms")
        print(events.table(sort_by="self_device_time_total", row_limit=15,
                           max_name_column_width=60))
        tag = (f"_{args.pre}" if apply else "") + (
            "_fused" if args.ortho == "cgs2_fused" else "")
        prof.export_chrome_trace(
            str(out / f"trace_{args.problem}{M}{tag}_{name}.json"))

    x = torch.randn(s.b.shape[0], dtype=s.b.dtype, device="cuda")
    print(f"\n== alone, CUDA events, operands warm in L2: A @ x "
          f"{_event_ms(lambda: s.A @ x):.4f} ms", end="")
    if apply is not None:
        print(f", one {span} {_event_ms(lambda: apply(x), reps=20):.4f} ms",
              end="")
    print()


if __name__ == "__main__":
    main()
