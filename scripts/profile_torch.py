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
``--loop while`` runs CGMRES on the device core, each step a CUDA graph
(captured in the warm-up pass), in place of the host loop; then replays
one graph of each kind alone under the profiler (after the solve, so every
write is masked) and prints its device operations and device time.
``--batch B`` (swe, ``--loop while``) profiles one ``cgmres_many`` solve
of B items on the batched device core in place of the GMRES and CGMRES
pair: item i is ``step_update(z0 + 0.02 i·p)``, p the smooth field of
``scripts/make_torch_reference.py`` (the rows ``swe_M512_B8`` and, with
``--pre snc``, ``swe_M512_snc_B8`` at B = 8); it prints the median wall of
5 unprofiled solves after the capture, and the batched DIA kernel's share
of device busy beside the graphs' operations.

    python scripts/profile_torch.py --problem heat [--pre amg|cheb8|neu4] [--M 1024] [--out build/profile]
    python scripts/profile_torch.py --problem swe [--pre none|snc] [--ortho cgs2|cgs2_fused] [--loop host|while]
    python scripts/profile_torch.py --problem swe --loop while --batch 8 [--pre snc]

Prints the busiest device kernels, the device-busy time against the wall
time of each solve (the device's idle share), the device time by kind
(stencil kernel and fused polynomial kernels by design, DIA kernel,
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
        return "stencil kernel, flat"
    if "stencil_tiled_kernel" in name:
        return "stencil kernel, tiled"
    if "dia_spmv_kernel" in name:
        return "DIA kernel"
    if "dia_spmm_" in name:  # its designs' kernels
        return "batched DIA kernel"
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


def _graph_ops(torch, profile, ProfilerActivity):
    """Device operations (kernels, copies, fills) and device time of one
    replay of the cached device core's graphs, the first and the last
    captured of each kind, replayed alone after the solve."""
    import importlib

    cgmres = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    core = next(iter(cgmres._CORES.values()))
    by_kind = {}
    for key in core.runner.graphs:  # in the order of capture
        by_kind.setdefault(key if isinstance(key, str) else key[0], []).append(key)
    print("\n== one replay of each graph alone: device operations, device ms")
    for kind, keys in sorted(by_kind.items()):
        for key in dict.fromkeys((keys[0], keys[-1])):
            graph = core.runner.graphs[key][0]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graph.replay()
                torch.cuda.synchronize()
            ops = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            us = sum(e.time_range.elapsed_us() for e in ops)
            print(f"   {key}: {len(ops)} operations, {us / 1e3:.3f} ms")


def _batched(s, B, cfg, pre):
    """One ``cgmres_many`` solve of B swe items, as a function of no
    arguments returning ``(X, info)``."""
    import importlib.util

    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )

    spec = importlib.util.spec_from_file_location(
        "make_torch_reference", ROOT / "scripts" / "make_torch_reference.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    z0 = s.z0.cpu().numpy()
    p = torch.as_tensor(ref.smooth_field(s.prob.M, z0), device=s.b.device)
    items = [s.step_update(s.z0 + 0.02 * i * p) for i in range(B)]
    Bs = torch.stack([t.b for t in items])
    cons = [t.constraints() for t in items]
    return lambda: cgmres_many(s.A, Bs, cons, k=cfg["k"], tol=cfg["tol"],
                               pre=pre)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=sorted(CONFIGS), default="heat")
    ap.add_argument("--pre", choices=["none", *sorted(PRE_RANGES)],
                    default=None,
                    help="the preconditioner (default: none for swe, the "
                         "AMG for heat)")
    ap.add_argument("--ortho", choices=["cgs2", "cgs2_fused"], default="cgs2")
    ap.add_argument("--loop", choices=["host", "while"], default="host",
                    help="CGMRES's loop: the host loop or the device core")
    ap.add_argument("--batch", type=int, default=None,
                    help="profile cgmres_many on this many swe items")
    ap.add_argument("--M", type=int, default=None)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    args.pre = args.pre or PRES[args.problem][0]
    if args.pre not in PRES[args.problem]:
        ap.error(f"--pre {args.pre} is not a preconditioner of {args.problem}")
    if args.batch is not None and (args.problem != "swe"
                                   or args.loop != "while"
                                   or args.ortho != "cgs2"):
        ap.error("--batch runs swe on the device core: --problem swe "
                 "--loop while, with --ortho cgs2")

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
        "cgmres": lambda: wrappers.cgmres_wrapper(s, loop=args.loop, **kw),
    }
    if args.batch is not None:
        solves = {f"cgmres_many_B{args.batch}": _batched(s, args.batch, cfg,
                                                          apply)}
    for fn in solves.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    if args.batch is not None:
        # the unprofiled wall of the batched solve, after its capture
        (fn,) = solves.values()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        print(f"\n== {next(iter(solves))}: wall, median of 5 unprofiled "
              f"solves {sorted(walls)[2]:.3f} ms "
              f"({', '.join(f'{w:.3f}' for w in walls)})")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name, fn in solves.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, info = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        # the ranges of the preconditioner and of the graph runner (its
        # replays and flag reads) are host spans, not device work
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key != span and not e.key.startswith("replay ")
                   and e.key not in ("flag read", "cgmres_many")]
        busy_us = sum(e.self_device_time_total for e in kernels)
        label = (f"{args.problem} --pre {args.pre} --ortho {args.ortho}"
                 f" --loop {args.loop}")
        steps = info["steps"]
        steps = steps if isinstance(steps, int) else list(map(int, steps))
        print(f"\n== {label} {name} M={M}: steps {steps}, wall "
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
            "_fused" if args.ortho == "cgs2_fused" else "") + (
            "_graphs" if args.loop == "while" else "")
        prof.export_chrome_trace(
            str(out / f"trace_{args.problem}{M}{tag}_{name}.json"))

    if args.loop == "while":
        _graph_ops(torch, profile, ProfilerActivity)

    x = torch.randn(s.b.shape[0], dtype=s.b.dtype, device="cuda")
    print(f"\n== alone, CUDA events, operands warm in L2: A @ x "
          f"{_event_ms(lambda: s.A @ x):.4f} ms", end="")
    if apply is not None:
        print(f", one {span} {_event_ms(lambda: apply(x), reps=20):.4f} ms",
              end="")
    print()


if __name__ == "__main__":
    main()
