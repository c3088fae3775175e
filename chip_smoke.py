#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; JAX is neither needed nor
imported.  Phases, each of which raises on a failed check:

1. build the DIA SpMV kernel from ``csrc/dia_spmv.cu``;
2. hold the kernel against its plain PyTorch twin in f64 and f32 on the
   shallow-water operator (M=512, wrapped) and the lkdv degree-3 M=100
   operators (A wrapped, the mass matrix not, ragged n), and time both at
   the shallow-water shape;
3. lkdv: the reference SingleSolve (M=50, degree 1, k=20) and the hard
   configuration (M=100, degree 3, k=50, tol=1e-6), which CGMRES must
   certify with a ≥2× invariant gain over GMRES;
4. swe at M=512 (n = 786,432) in f64, k=60, tol=1e-9, unpreconditioned:
   GMRES and CGMRES, held against the JAX package's record
   (``reference/slice1.json``), counting the kernel's launches.

The line before the last is the kernel report as JSON; the last line is the
device record.  Exits non-zero, printing no result, without a CUDA device
or outside a checkout.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "structurepreservingiterativesolvers_torch"

# kernel against plain: the same multiply-adds in the same diagonal order,
# but the compiler contracts them into fused multiply-adds, which round once
# instead of twice; the bounds are on max|Δy| / max|y|
KERNEL_RTOL = {"float64": 1e-14, "float32": 1e-6}
# the certificate of the solvers (the JAX package's acceptance bars)
DEVIATION_MAX = 1e-10
SWE_TOL, SWE_K, SWE_M = 1e-9, 60, 512
DEVICE = "cuda"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_build():
    from structurepreservingiterativesolvers_torch.kernels import build

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    path, log = build.build("dia_spmv.cu")
    secs = time.perf_counter() - t0
    print(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    build.load("dia_spmv.cu")
    return secs


def _time_ms(fn, reps=200):
    import torch

    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(swe_sys, lkdv_sys):
    import torch

    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv,
        dia_spmv_torch,
    )

    ops = {"swe_M512_A": swe_sys.A, "lkdv_hard_A": lkdv_sys.A,
           "lkdv_hard_Mmat": lkdv_sys.Mmat}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    max_abs_f64 = 0.0
    for name, A in ops.items():
        for dtype in (torch.float64, torch.float32):
            data = A.data.to(dtype)
            x = torch.randn(A.shape[0], generator=gen, device=DEVICE, dtype=dtype)
            y = dia_spmv(data, A.offsets, A.wrap, x)
            torch.cuda.synchronize()
            ref = dia_spmv_torch(data, A.offsets, A.wrap, x)
            torch.cuda.synchronize()
            abs_err = float((y - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            tag = str(dtype).split(".")[-1]
            print(f"[kernel] {name} n={A.shape[0]} ndiag={len(A.offsets)} "
                  f"wrap={A.wrap} {tag}: max|dy|/max|y| = {rel:.3e} "
                  f"(bound {KERNEL_RTOL[tag]:.0e})")
            check(math.isfinite(rel) and rel <= KERNEL_RTOL[tag],
                  f"kernel disagrees with plain on {name} {tag}: {rel:.3e}")
            if dtype == torch.float64:
                max_abs_f64 = max(max_abs_f64, abs_err)

    A = swe_sys.A
    x = torch.randn(A.shape[0], generator=gen, device=DEVICE, dtype=torch.float64)
    ms = _time_ms(lambda: dia_spmv(A.data, A.offsets, A.wrap, x))
    plain_ms = _time_ms(lambda: dia_spmv_torch(A.data, A.offsets, A.wrap, x),
                        reps=50)
    nbytes = (len(A.offsets) + 2) * A.shape[0] * 8
    print(f"[kernel] swe M=512 f64 SpMV: kernel {ms:.4f} ms "
          f"({nbytes / ms / 1e6:.0f} GB/s of {nbytes / 1e6:.1f} MB), "
          f"plain {plain_ms:.4f} ms")
    return max_abs_f64, ms, plain_ms


def _deviations(system, x):
    from structurepreservingiterativesolvers_torch.experiments import report

    inv = system.compute_invariants(x)
    targets = report._targets(system, list(inv))
    return {k: float(v) - targets[k] for k, v in inv.items()}


def _within_one(info, rec, key):
    return abs(int(info.get(key, 0)) - int(rec.get(key, 0))) <= 1


def phase_lkdv(record):
    import torch

    from structurepreservingiterativesolvers_torch.experiments.single_solve import (
        single_solve,
    )
    from structurepreservingiterativesolvers_torch.models import lkdv
    from structurepreservingiterativesolvers_torch.solvers import cgmres, gmres

    out = single_solve(problem="lkdv", M=50, degree=1, k=20, device=DEVICE,
                       verbose=False)
    devs = out["deviations"]["cgmres"]
    print(f"[lkdv easy] SingleSolve cgmres deviations {devs}, "
          f"errors vs direct: cgmres {out['cgmres_error']:.3e}, "
          f"gmres {out['gmres_error']:.3e}")
    check(max(abs(d) for d in devs.values()) <= DEVIATION_MAX,
          f"lkdv easy CGMRES deviations {devs}")
    rec = record["lkdv_easy"]["cgmres"]
    info = out["cgmres"][1]
    check(_within_one(info, rec, "steps") and info["safety"] == rec["safety"],
          f"lkdv easy steps {info['steps']} / safety {info['safety']} vs "
          f"record {rec['steps']} / {rec['safety']}")

    s = lkdv.linforms(M=100, degree=3, device=DEVICE)
    xg, ig = gmres(s.A, s.b, k=50, tol=1e-6)
    xc, ic = cgmres(s.A, s.b, k=50, tol=1e-6, constraints=s.constraints())
    torch.cuda.synchronize()
    dg, dc = _deviations(s, xg), _deviations(s, xc)
    print(f"[lkdv hard] gmres steps {ig['steps']} deviations {dg}")
    print(f"[lkdv hard] cgmres steps {ic['steps']} constrained "
          f"{ic['constrained_steps']} safety {ic['safety']} deviations {dc}")
    check(ic["safety"] is True, "lkdv hard CGMRES safety is not True")
    check(max(abs(d) for d in dc.values()) <= DEVIATION_MAX,
          f"lkdv hard CGMRES deviations {dc}")
    for key in dc:
        check(2.0 * abs(dc[key]) <= abs(dg[key]) + 1e-16,
              f"lkdv hard: no 2x gain on {key}: {dc[key]:.3e} vs {dg[key]:.3e}")
    rec = record["lkdv_hard"]["cgmres"]
    check(_within_one(ic, rec, "steps")
          and _within_one(ic, rec, "constrained_steps"),
          f"lkdv hard steps {ic['steps']}/{ic['constrained_steps']} vs record "
          f"{rec['steps']}/{rec['constrained_steps']}")


def phase_swe(s, record):
    """The main path: both solvers at full size, through the wrappers a
    user calls.  Returns the kernel launches counted over it."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv_cuda,
    )

    # one untimed, uncounted pass first: the library set-up of the first
    # large f64 products and the allocator's first blocks are paid there
    t0 = time.perf_counter()
    wrappers.gmres_wrapper(s, k=SWE_K, tol=SWE_TOL)
    wrappers.cgmres_wrapper(s, k=SWE_K, tol=SWE_TOL)
    torch.cuda.synchronize()
    print(f"[swe M={SWE_M}] first pass (GMRES + CGMRES, set-up included) "
          f"{time.perf_counter() - t0:.4f} s")

    dia_spmv_cuda.launches = 0
    t0 = time.perf_counter()
    xg, ig = wrappers.gmres_wrapper(s, k=SWE_K, tol=SWE_TOL)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    xc, ic = wrappers.cgmres_wrapper(s, k=SWE_K, tol=SWE_TOL, timing=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dia_spmv_cuda.launches

    rec = record["swe_M512"]
    wall_g, wall_c = t1 - t0, t2 - t1
    print(f"[swe M={SWE_M}] n={s.b.shape[0]} gmres: steps {ig['steps']} "
          f"(record {rec['gmres']['steps']}), wall {wall_g:.4f} s, "
          f"{1e3 * wall_g / max(ig['steps'], 1):.3f} ms/iteration")
    t = ic["timings"]
    print(f"[swe M={SWE_M}] cgmres: steps {ic['steps']} (record "
          f"{rec['cgmres']['steps']}), constrained {ic['constrained_steps']} "
          f"(record {rec['cgmres']['constrained_steps']}), safety "
          f"{ic['safety']}, deviation {ic['deviation']:.3e}, wall "
          f"{wall_c:.4f} s; phase 1 {1e3 * t['iter_time_unconstrained']:.3f} "
          f"ms/iteration over {t['phase1_steps_measured']}, catch-up "
          f"{1e3 * t['constraint_building']:.3f} ms, endgame "
          f"{1e3 * t['iter_time_constrained']:.3f} ms/iteration")
    print(f"[swe M={SWE_M}] DIA kernel launches over both solves: {launches}")

    res_c = float(torch.linalg.norm(s.b - s.A @ xc))
    res_g = float(torch.linalg.norm(s.b - s.A @ xg))
    print(f"[swe M={SWE_M}] true residuals: cgmres {res_c:.4e} (record "
          f"{rec['cgmres']['true_residual']:.4e}), gmres {res_g:.4e}")
    print(f"[swe M={SWE_M}] cgmres invariant deviations {_deviations(s, xc)}")
    check(launches > 0, "the swe solves launched no DIA kernel")
    check(ic["safety"] is True, "swe CGMRES safety is not True")
    check(ic["deviation"] <= DEVIATION_MAX,
          f"swe CGMRES deviation {ic['deviation']:.3e}")
    check(res_c < SWE_TOL and math.isfinite(res_c),
          f"swe CGMRES true residual {res_c:.3e}")
    check(xc.shape == s.b.shape and bool(torch.isfinite(xc).all()),
          "swe CGMRES iterate is not finite")
    # the card sums in another order than the CPU that wrote the record, so
    # the step at which the residual crosses tol (and the gate opens) may
    # move by one
    for key in ("steps", "constrained_steps"):
        check(_within_one(ic, rec["cgmres"], key),
              f"swe cgmres {key} {ic.get(key)} vs record "
              f"{rec['cgmres'].get(key)}")
    check(_within_one(ig, rec["gmres"], "steps"),
          f"swe gmres steps {ig['steps']} vs record {rec['gmres']['steps']}")
    return launches


def main() -> int:
    if not (PACKAGE / "csrc" / "dia_spmv.cu").is_file():
        fail(f"run from a checkout of the repository: {PACKAGE} is missing")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU only")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from structurepreservingiterativesolvers_torch.models import lkdv, swe

    record = json.loads((PACKAGE / "reference" / "slice1.json").read_text())
    phase_build()
    t0 = time.perf_counter()
    swe_sys = swe.linforms(M=SWE_M, device=DEVICE)
    print(f"[swe M={SWE_M}] assembly {time.perf_counter() - t0:.2f} s")
    max_abs, ms, plain_ms = phase_kernel(
        swe_sys, lkdv.linforms(M=100, degree=3, device=DEVICE))
    torch.cuda.synchronize()
    phase_lkdv(record)
    torch.cuda.synchronize()
    launches = phase_swe(swe_sys, record)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [{
        "name": "dia_spmv",
        "route": "cuda",
        "source": "structurepreservingiterativesolvers_torch/csrc/dia_spmv.cu",
        "replaces": "structurepreservingiterativesolvers_tpu/ops/pallas_spmv.py:91",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
