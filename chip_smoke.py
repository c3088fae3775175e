#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; JAX is neither needed nor
imported.  Phases, each of which raises on a failed check:

1. build the five kernel sources from ``csrc/`` (``dia_spmv.cu``,
   ``stencil_spmv.cu``, ``poly_apply.cu``, ``poly_tiled.cu``,
   ``ortho_fused.cu``), one ``nvcc`` for each source, started together;
2. hold the DIA kernel against its plain PyTorch twin in f64 and f32 on the
   shallow-water operator (M=512, wrapped) and the lkdv degree-3 M=100
   operators (A wrapped, the mass matrix not, ragged n), and time it at the
   shallow-water shape;
3. lkdv: the reference SingleSolve (M=50, degree 1, k=20) and the hard
   configuration (M=100, degree 3, k=50, tol=1e-6), which CGMRES must
   certify with a ≥2× invariant gain over GMRES;
4. swe at M=512 (n = 786,432) in f64, k=60, tol=1e-9, unpreconditioned:
   GMRES and CGMRES, held against the JAX package's record
   (``reference/slice1.json``), counting the DIA kernel's launches;
5. heat at M=1024 (n = 1,050,625) in f64, k=20, tol=1e-7 absolute, with
   the structured AMG: the TimedSolve row (``time_cgmres``), counting both
   kernels' launches, then one more GMRES and CGMRES pair for the launches
   per solve and the iterate, held against the JAX package's record
   (``reference/slice2.json``);
6. hold the stencil kernel against its plain twin in f64 and f32 on the
   heat M=1024 and M=16 operators, and the DIA kernel on heat's matrices,
   and time both kernels, their plain twins and one cuSPARSE CSR matvec of
   the same matrix at the heat M=1024 shape, with the L2 cache flushed
   before each launch, beside the least time the card could take;
7. hold the fused Chebyshev and Neumann applies against their plain twins
   in f64 and f32, in the design the dispatch picks from the shapes: the
   tiled one (``poly_tiled.cu``) on the heat M=1024 and M=16 stencils, with
   two launches on the same input bit-equal, and the flat one
   (``poly_apply.cu``) on the swe M=512 wrapped DIA; then time them at heat
   M=1024 in f64 with L2 flushed, the tiled design (at its plan and at every
   tile that fits, which must all give the same bits) beside the flat one on
   the same input, their bound, their plain twins and the unfused chain of
   SpMV kernels (``fused=False``);
8. the third slice's full-width rows: the heat M=1024 TimedSolve row
   (k=20, tol=1e-7) through ``time_cgmres`` with a ``chebyshev(degree=8)``
   and a ``neumann(degree=4)`` pre-builder in place of the AMG, counting
   the kernels' launches over each row and per solve, held against the JAX
   package's record (``reference/slice3.json``); every apply of these rows
   runs the tiled design, none the flat one.  A fixed-degree polynomial
   stalls at this size, in the JAX package too, so these rows end
   uncertified, and no deviation is compared;
9. the certified anchors of the third slice: heat M=256 (k=60) with cheb8
   and heat M=64 (k=60) with cheb8 and with neu4, each held to its record's
   counts and safety and to the certificate, through the tiled design;
10. hold the fused CGS2 update (kernel #5, ``ortho_fused.cu``) against its
    plain twin in f64 and f32 for m = 1, 2, 21, 61 and 128 basis rows at
    n = 786,432 (swe M=512), 1,050,625 (heat M=1024) and a ragged 1,000,
    with two launches on the same input bit-equal, and time it with L2
    flushed at swe M=512 (m = 21, 61) and heat M=1024 (m = 21) beside its
    bound and the unfused pair of cuBLAS products, its plain twin;
11. the first slice's swe M=512 row again (k=60, tol=1e-9) with
    ``ortho="cgs2_fused"``, where the basis grows to 41 rows, held to
    ``reference/slice1.json``, with kernel #5 launched once per Arnoldi step;
12. the fourth slice's full-width rows, held to ``reference/slice4.json``:
    the swe M=512 TimedSolve row (k=20, tol=1e-7) through ``time_cgmres``
    with the default skew-normal Chebyshev pre-builder and the fused
    orthogonalisation, and three steps of ``evolve`` on swe M=512 (T=0.3,
    so dt = 0.1 as in the row), counting kernels #1 and #5 over each.

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
# the fused polynomial applies against their plain twins: the same
# recurrence in the same order, p products each summed as the SpMV kernels
# sum it, so the contraction differences of p steps add up; max|Δy| / max|y|
POLY_RTOL = {"float64": 1e-13, "float32": 1e-5}
# the certificate of the solvers (the JAX package's acceptance bars)
DEVIATION_MAX = 1e-10
SWE_TOL, SWE_K, SWE_M = 1e-9, 60, 512
HEAT_TOL, HEAT_K, HEAT_M = 1e-7, 20, 1024
SWE_N, HEAT_N = 3 * SWE_M**2, (HEAT_M + 1) ** 2
DEVICE = "cuda"
SOURCES = ("dia_spmv.cu", "stencil_spmv.cu", "poly_apply.cu", "poly_tiled.cu",
           "ortho_fused.cu")
# the third slice: the polynomial pre-builders as a user writes them
# (degree, and Neumann's default damping), and its record's tolerances
CHEB_DEGREE, NEU_DEGREE, NEU_OMEGA = 8, 4, 0.8
BOUNDS_RTOL, RESIDUAL_RTOL = 1e-10, 1e-6
ANCHORS = (("heat_M256_cheb8", 256, 60, "cheb8"),
           ("heat_M64_cheb8", 64, 60, "cheb8"),
           ("heat_M64_neu4", 64, 60, "neu4"))
# the fused CGS2 update against its plain twin (two cuBLAS products): the
# same sums in another order; max|Δ| / max|ref| on w1 and on u2, with random
# h so that u2 does not cancel
ORTHO_RTOL = {"float64": 1e-13, "float32": 1e-5}
ORTHO_ROWS = (1, 2, 21, 61, 128)
# the fourth slice: the swe TimedSolve row and the evolution
SNC_TOL, SNC_K = 1e-7, 20
EVOLVE_N, EVOLVE_T = 3, 0.3
# NVIDIA H100 SXM data sheet: HBM3 rate, and the f64 rate outside the
# tensor cores (the kernels' multiply-adds run there)
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from structurepreservingiterativesolvers_torch.kernels import build

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build.build, SOURCES))
    secs = time.perf_counter() - t0
    for source, (path, log) in zip(SOURCES, built):
        print(f"[build] {path.relative_to(ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        build.load(source)
    print(f"[build] {len(SOURCES)} sources in {secs:.2f} s")
    return secs


def _time_ms(fn, reps=200):
    """Mean time per call over a run of calls: the operands stay in L2."""
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


def _time_cold_ms(fn, reps=50):
    """Mean device time per call with the 50 MB L2 flushed before each call,
    so every operand comes from device memory, as the bound counts it.  The
    flush reads a 256 MB buffer: it leaves L2 holding clean lines, so the
    timed call pays no write-back of the flush's data.  A spin of about
    half a millisecond on the card before each flush lets the host queue
    the flush, the events and the call ahead of the card, so the time
    between the events holds no wait for the host."""
    import torch

    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=DEVICE)
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _bound_ms(nbytes, nflop):
    """The least time the card could take: bytes over the memory rate or
    f64 operations over the f64 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nflop / F64_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _csr(A_csr):
    """The library yardstick's operand: a CUDA CSR tensor (cuSPARSE SpMV)."""
    import warnings

    import torch

    A = A_csr.tocsr()
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(A.indptr, dtype=torch.int64),
            torch.as_tensor(A.indices, dtype=torch.int64),
            torch.as_tensor(A.data, dtype=torch.float64),
            size=A.shape, device=DEVICE)


def _rel_err(y, ref):
    abs_err = float((y - ref).abs().max())
    return abs_err, abs_err / float(ref.abs().max())


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
            abs_err, rel = _rel_err(y, dia_spmv_torch(data, A.offsets,
                                                      A.wrap, x))
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
    _time_dia(A, swe_sys.A_csr, x, "swe M=512")
    return max_abs_f64


def _time_dia(A, A_csr, x, label):
    """The DIA kernel, its plain twin and the cuSPARSE matvec of the same
    matrix, each with L2 flushed; returns the timing fields of the report."""
    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv,
        dia_spmv_torch,
    )

    Acsr = _csr(A_csr)
    n, ndiag = A.shape[0], len(A.offsets)
    out = {
        "ms": _time_cold_ms(lambda: dia_spmv(A.data, A.offsets, A.wrap, x)),
        "plain_ms": _time_cold_ms(
            lambda: dia_spmv_torch(A.data, A.offsets, A.wrap, x), reps=20),
        "library_ms": _time_cold_ms(lambda: Acsr @ x),
    }
    # data and x read once, y written once; a multiply and an add per entry
    out["bound_ms"], out["bound_by"] = _bound_ms((ndiag + 2) * n * 8,
                                                 2 * ndiag * n)
    print(f"[kernel] DIA SpMV at {label} (n={n}, ndiag={ndiag}, f64, L2 "
          f"flushed): kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} "
          f"ms, cuSPARSE CSR {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


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
    """The first slice's path: both solvers at full size, through the
    wrappers a user calls.  Returns the DIA kernel launches counted over
    it."""
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


def phase_heat(record):
    """The main path of the second slice: the heat TimedSolve row at full
    size through ``time_cgmres`` with the heat pre-builder.  Returns the
    system, the AMG and both kernels' launches over the row."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
        time_cgmres,
    )
    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv_cuda,
    )
    from structurepreservingiterativesolvers_torch.kernels.stencil_spmv import (
        stencil_spmv_cuda,
    )

    seen = {}

    def pre_builder(system):  # the default, keeping what it was given
        seen["system"] = system
        seen["pre"] = default_pre_builder("heat")(system)
        return seen["pre"]

    dia_spmv_cuda.launches = stencil_spmv_cuda.launches = 0
    t0 = time.perf_counter()
    out = time_cgmres("heat", M=HEAT_M, k=HEAT_K, tol=HEAT_TOL,
                      pre_builder=pre_builder, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dia_spmv": dia_spmv_cuda.launches,
                "stencil_spmv": stencil_spmv_cuda.launches}
    s, pre = seen["system"], seen["pre"]
    rec = record[f"heat_M{HEAT_M}"]
    levels = [L.A.shape[0] for L in pre.levels]
    tag = f"[heat M={HEAT_M}]"
    print(f"{tag} n={s.b.shape[0]} operator {type(s.A).__name__} "
          f"offsets {s.A.offsets} grid_c {getattr(s.A, 'grid_c', None)}")
    print(f"{tag} time_cgmres wall {wall:.3f} s (assembly, two AMG builds, "
          f"warm-up and timed solves); AMG setup first build "
          f"{out['time_pre_first']:.4f} s, second {out['time_pre']:.4f} s; "
          f"levels {levels} (record {rec['amg_levels']}); warm-up pass "
          f"{out['compile_time']:.4f} s")
    print(f"{tag} gmres: steps {out['gmres_steps']} (record "
          f"{rec['gmres']['steps']}), wall {out['time_gmres']:.4f} s, "
          f"{1e3 * out['time_gmres'] / max(out['gmres_steps'], 1):.3f} "
          f"ms/iteration, final residual {out['gmres_res_final']:.4e}")
    print(f"{tag} cgmres: steps {out['steps']} (record "
          f"{rec['cgmres']['steps']}), constrained {out['constrained_steps']} "
          f"(record {rec['cgmres']['constrained_steps']}), safety "
          f"{out['safety']}, wall {out['runtime']:.4f} s; phase 1 "
          f"{1e3 * out['iter_time_unconstrained']:.3f} ms/iteration over "
          f"{out['phase1_steps_measured']}, catch-up "
          f"{1e3 * out['constraint_building']:.3f} ms, endgame "
          f"{1e3 * out['iter_time_constrained']:.3f} ms/iteration; final "
          f"residual {out['res_final']:.4e}")
    con = out["conservation"]
    for nm in out["invariant_names"]:
        gain = max(con[f"gmres_{nm}"], 1e-16) / max(con[f"cgmres_{nm}"], 1e-16)
        print(f"{tag} {nm}: deviation gmres {con[f'gmres_{nm}']:.3e}, cgmres "
              f"{con[f'cgmres_{nm}']:.3e}, gain {gain:.3e}, floor-dominated "
              f"{con[f'floor_{nm}']}")
    print(f"{tag} launches over the TimedSolve row: {launches}")

    # one more pair: the launches per solve, and the iterate itself
    per_solve = {}
    for name, call in (("gmres", wrappers.gmres_wrapper),
                       ("cgmres", wrappers.cgmres_wrapper)):
        dia_spmv_cuda.launches = stencil_spmv_cuda.launches = 0
        x, info = call(s, k=HEAT_K, tol=HEAT_TOL, pre=pre)
        torch.cuda.synchronize()
        per_solve[name] = (x, info, dia_spmv_cuda.launches,
                           stencil_spmv_cuda.launches)
        print(f"{tag} one {name} solve: {info['steps']} steps, DIA kernel "
              f"{dia_spmv_cuda.launches} launches, stencil kernel "
              f"{stencil_spmv_cuda.launches}")
    xc, ic = per_solve["cgmres"][:2]
    xg, ig = per_solve["gmres"][:2]
    res_c = float(torch.linalg.norm(s.b - s.A @ xc))
    res_g = float(torch.linalg.norm(s.b - s.A @ xg))
    print(f"{tag} true residuals: cgmres {res_c:.4e} (record "
          f"{rec['cgmres']['true_residual']:.4e}), gmres {res_g:.4e} (record "
          f"{rec['gmres']['true_residual']:.4e}); cgmres KKT deviation "
          f"{ic['deviation']:.3e} (record {rec['cgmres']['deviation']:.3e})")
    print(f"{tag} cgmres invariant deviations {_deviations(s, xc)}")

    check(launches["dia_spmv"] > 0 and launches["stencil_spmv"] > 0,
          f"the heat row did not go through both kernels: {launches}")
    check(levels == rec["amg_levels"],
          f"AMG levels {levels} vs record {rec['amg_levels']}")
    for info in (out, ic):
        check(info["safety"] is True, "heat CGMRES safety is not True")
    check(max(con[f"cgmres_{nm}"] for nm in out["invariant_names"])
          <= DEVIATION_MAX and ic["deviation"] <= DEVIATION_MAX,
          f"heat CGMRES deviations {con}, KKT {ic['deviation']:.3e}")
    check(math.isfinite(res_c) and res_c < HEAT_TOL,
          f"heat CGMRES true residual {res_c:.3e}")
    check(xc.shape == s.b.shape and bool(torch.isfinite(xc).all()),
          "heat CGMRES iterate is not finite")
    # the card sums in another order than the CPU that wrote the record, so
    # the step at which the residual crosses tol may move by one
    for info in (out, ic):
        for key in ("steps", "constrained_steps"):
            check(_within_one(info, rec["cgmres"], key),
                  f"heat cgmres {key} {info.get(key)} vs record "
                  f"{rec['cgmres'].get(key)}")
    for steps in (out["gmres_steps"], ig["steps"]):
        check(abs(steps - rec["gmres"]["steps"]) <= 1,
              f"heat gmres steps {steps} vs record {rec['gmres']['steps']}")
    return s, pre, launches


def phase_heat_kernels(s, pre):
    """Both kernels against their plain twins on heat's operators and the
    AMG's, and their times at the heat M=1024 shape.  Returns the report's
    fields."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv,
        dia_spmv_torch,
    )
    from structurepreservingiterativesolvers_torch.kernels.stencil_spmv import (
        stencil_spmv,
        stencil_spmv_torch,
    )
    from structurepreservingiterativesolvers_torch.models import heat

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    small = heat.linforms(M=16, device=DEVICE)
    stencil_err, dia_err = 0.0, 0.0
    for label, S in ((f"heat M={HEAT_M}", s.A), ("heat M=16", small.A)):
        check(S.grid_c > 0, f"{label} operator has no strips")
        for dtype in (torch.float64, torch.float32):
            strips = tuple(t.to(dtype) for t in S.strips)
            x = torch.randn(S.shape[0], generator=gen, device=DEVICE,
                            dtype=dtype)
            args = (S.const, S.offsets, S.wrap, S.grid_c, strips, x)
            y = stencil_spmv(*args)
            torch.cuda.synchronize()
            abs_err, rel = _rel_err(y, stencil_spmv_torch(*args))
            tag = str(dtype).split(".")[-1]
            print(f"[kernel] stencil {label} n={S.shape[0]} grid_c={S.grid_c} "
                  f"{tag}: max|dy|/max|y| = {rel:.3e} (bound "
                  f"{KERNEL_RTOL[tag]:.0e})")
            check(math.isfinite(rel) and rel <= KERNEL_RTOL[tag],
                  f"stencil kernel disagrees with plain on {label} {tag}: "
                  f"{rel:.3e}")
            if dtype == torch.float64:
                stencil_err = max(stencil_err, abs_err)
                # and the decomposition against the explicit operator
                _, rel_d = _rel_err(y, dia_spmv_torch(S.data, S.offsets,
                                                      S.wrap, x))
                check(rel_d <= KERNEL_RTOL[tag],
                      f"stencil {label} differs from its DIA: {rel_d:.3e}")
    for label, A in (("A", s.A.dia), ("Mmat", s.Mmat), ("Emat", s.Emat),
                     ("AMG S_P", pre.levels[0].P.S),
                     ("AMG S_R", pre.levels[0].R.S),
                     ("AMG level-1 A", pre.levels[1].A)):
        x = torch.randn(A.shape[0], generator=gen, device=DEVICE,
                        dtype=torch.float64)
        y = dia_spmv(A.data, A.offsets, A.wrap, x)
        torch.cuda.synchronize()
        abs_err, rel = _rel_err(y, dia_spmv_torch(A.data, A.offsets, A.wrap, x))
        print(f"[kernel] DIA heat M={HEAT_M} {label} n={A.shape[0]} "
              f"ndiag={len(A.offsets)} f64: max|dy|/max|y| = {rel:.3e}")
        check(rel <= KERNEL_RTOL["float64"],
              f"DIA kernel disagrees with plain on heat {label}: {rel:.3e}")
        dia_err = max(dia_err, abs_err)

    # times at the main path's shapes, f64, L2 flushed before each call
    S = s.A
    n, ndiag = S.shape[0], len(S.offsets)
    R = n // S.grid_c
    x = torch.randn(n, generator=gen, device=DEVICE, dtype=torch.float64)
    args = (S.const, S.offsets, S.wrap, S.grid_c, S.strips, x)
    Acsr = _csr(s.A_csr)
    st = {
        "ms": _time_cold_ms(lambda: stencil_spmv(*args)),
        "plain_ms": _time_cold_ms(lambda: stencil_spmv_torch(*args), reps=20),
        "library_ms": _time_cold_ms(lambda: Acsr @ x),
    }
    # x read once and y written once, the strips read once
    nbytes = (2 * n + 2 * (S.grid_c + R) * ndiag) * 8
    st["bound_ms"], st["bound_by"] = _bound_ms(nbytes, 2 * ndiag * n)
    warm = _time_ms(lambda: stencil_spmv(*args))
    _, rel = _rel_err(Acsr @ x, stencil_spmv(*args))
    print(f"[kernel] stencil SpMV at heat M={HEAT_M} (n={n}, ndiag={ndiag}, "
          f"f64, L2 flushed): kernel {st['ms']:.4f} ms "
          f"({nbytes / st['ms'] / 1e6:.0f} GB/s of {nbytes / 1e6:.2f} MB), "
          f"plain {st['plain_ms']:.4f} ms, cuSPARSE CSR "
          f"{st['library_ms']:.4f} ms (max|dy|/max|y| {rel:.1e} against the "
          f"kernel), bound {st['bound_ms']:.4f} ms ({st['bound_by']}); "
          f"back-to-back calls with x in L2 {warm:.4f} ms each (bound by the "
          f"host's issue rate where it exceeds the kernel's time)")
    check(rel <= 1e-13, f"cuSPARSE CSR disagrees with the stencil: {rel:.3e}")
    dia = _time_dia(S.dia, s.A_csr, x, f"heat M={HEAT_M} A")
    return stencil_err, st, dia_err, dia



def _poly_builders():
    """name -> the pre-builder of the third slice, as a user writes it."""
    from structurepreservingiterativesolvers_torch.precond import (
        chebyshev,
        neumann,
    )

    return {"cheb8": lambda s: chebyshev(s.A, degree=CHEB_DEGREE),
            "neu4": lambda s: neumann(s.A, degree=NEU_DEGREE, omega=NEU_OMEGA)}


def _poly_launches():
    """The launch counters of the four kernels by name, and of each design
    of the polynomial applies (``<name>_tiled``, ``<name>_flat``)."""
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv_cuda,
    )
    from structurepreservingiterativesolvers_torch.kernels.stencil_spmv import (
        stencil_spmv_cuda,
    )

    return {"cheb_apply": pa.cheb_apply_cuda,
            "cheb_apply_tiled": pa.cheb_apply_tiled_cuda,
            "cheb_apply_flat": pa.cheb_apply_flat_cuda,
            "neumann_apply": pa.neumann_apply_cuda,
            "neumann_apply_tiled": pa.neumann_apply_tiled_cuda,
            "neumann_apply_flat": pa.neumann_apply_flat_cuda,
            "stencil_spmv": stencil_spmv_cuda, "dia_spmv": dia_spmv_cuda}


def _check_tiled(tag, launches, kernel):
    """Every launch of ``kernel`` in ``launches`` ran the tiled design."""
    tiled, flat = launches[f"{kernel}_tiled"], launches[f"{kernel}_flat"]
    print(f"{tag} {kernel} design: {tiled} tiled, {flat} flat launches")
    check(launches[kernel] > 0 and tiled == launches[kernel] and flat == 0,
          f"{tag} {kernel}: {launches[kernel]} launches, {tiled} tiled")


def _reset_launches():
    for fn in _poly_launches().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _poly_launches().items()}


def phase_poly_kernels(ops, applies=None):
    """Kernels #3 and #4 against their plain twins in f64 and f32 on each
    operator of ``ops`` (label -> operator on the card), Chebyshev with the
    bounds ``chebyshev()`` computes for it and Neumann with the builder's
    D⁻¹, through the dispatch, which must pick the design ``poly_design``
    names (tiled on a stencil with strips): each launch counts there and
    nowhere else, and a second launch of the tiled design gives the same
    bits.  ``applies`` maps a label to its (kind, degree) list, by default
    (cheb, 8) and (neumann, 4).  Returns the largest f64 absolute error of
    each kernel."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.precond import (
        chebyshev,
        neumann,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    errs = {"cheb_apply": 0.0, "neumann_apply": 0.0}
    for label, A in ops.items():
        base = chebyshev(A, degree=CHEB_DEGREE)
        theta = 0.5 * (base.lmax + base.lmin)
        delta = 0.5 * (base.lmax - base.lmin)
        todo = (applies or {}).get(label, [("cheb", CHEB_DEGREE),
                                           ("neumann", NEU_DEGREE)])
        for dtype in (torch.float64, torch.float32):
            Ad = A.astype(dtype)
            dinv = neumann(Ad, degree=NEU_DEGREE).dinv
            v = torch.randn(A.shape[0], generator=gen, device=DEVICE,
                            dtype=dtype)
            tag = str(dtype).split(".")[-1]
            for kind, degree in todo:
                design = pa.poly_design(Ad, kind, degree, dtype)
                if kind == "cheb":
                    args = (Ad, degree, theta, delta, theta / delta, v)
                    apply, plain = pa.cheb_apply, pa.cheb_apply_torch
                else:
                    args = (Ad, dinv, degree, NEU_OMEGA, v)
                    apply, plain = pa.neumann_apply, pa.neumann_apply_torch
                counter = getattr(pa, f"{kind}_apply_{design}_cuda")
                before = counter.launches
                y = apply(*args)
                torch.cuda.synchronize()
                check(counter.launches == before + 1,
                      f"{kind} p={degree} {label} did not launch the "
                      f"{design} design")
                ref = plain(*args)
                repeat = ""
                if design == "tiled":
                    again = apply(*args)
                    torch.cuda.synchronize()
                    check(torch.equal(y, again),
                          f"{kind} p={degree} {label} {tag}: two launches "
                          f"of the tiled design differ")
                    repeat = ", a second launch bit-equal"
                abs_err, rel = _rel_err(y, ref)
                print(f"[poly] {kind} p={degree} {label} n={A.shape[0]} "
                      f"{type(A).__name__} wrap={A.wrap} {tag}, {design} "
                      f"design: max|dy|/max|y| = {rel:.3e} (bound "
                      f"{POLY_RTOL[tag]:.0e}){repeat}")
                check(y.dtype == dtype and math.isfinite(rel)
                      and rel <= POLY_RTOL[tag],
                      f"{kind} kernel disagrees with plain on {label} p={degree} "
                      f"{tag}: {rel:.3e}")
                if dtype == torch.float64:
                    name = f"{kind}_apply"
                    errs[name] = max(errs[name], abs_err)
    return errs


def _time_tiles(label, S, kind, degree, apply_tiled, y_ref, best):
    """The tiled design at every tile that fits, L2 flushed: each must give
    the bits of the planned tile (a point's arithmetic does not depend on
    the tile that holds it).  Returns {"RxC": ms}."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa

    out = {}
    for plan in pa.tile_candidates(S.shape[0], S.grid_c, tuple(S.offsets),
                                   pa.sweeps(kind, degree), 8):
        y = apply_tiled(plan)
        torch.cuda.synchronize()
        check(torch.equal(y, y_ref),
              f"{label} tile {plan.tile_r}x{plan.tile_c} changes the bits")
        key = f"{plan.tile_r}x{plan.tile_c}"
        out[key] = _time_cold_ms(lambda: apply_tiled(plan), reps=20)
        print(f"[poly] {label} tile {key}{' (planned)' if plan == best else ''}"
              f": {out[key]:.4f} ms L2 flushed; {plan.blocks_per_sm} blocks "
              f"per SM, {plan.tiles} tiles, {plan.smem_bytes} B shared, "
              f"planner's cost {plan.cost}")
    return out


def phase_poly_timing(s):
    """Kernels #3 and #4 at the heat M=1024 stencil in f64, L2 flushed: the
    tiled design the main path runs (at its plan, and at every tile that
    fits) beside the flat one on the same input, their bound, their plain
    twins and the unfused chain (p launches of the stencil kernel and the
    vector updates between them).  Returns the report's fields per
    kernel."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.precond import (
        chebyshev,
        neumann,
    )

    S = s.A
    n, ndiag = S.shape[0], len(S.offsets)
    R = n // S.grid_c
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    v = torch.randn(n, generator=gen, device=DEVICE, dtype=torch.float64)
    strip_bytes = 2 * (S.grid_c + R) * ndiag * 8

    cheb = chebyshev(S, degree=CHEB_DEGREE)
    check(cheb.fused is True, "chebyshev() of a card operator did not fuse")
    chain = chebyshev(S, cheb.lmin, cheb.lmax, degree=CHEB_DEGREE, fused=False)
    theta = 0.5 * (cheb.lmax + cheb.lmin)
    delta = 0.5 * (cheb.lmax - cheb.lmin)
    cargs = (S, CHEB_DEGREE, theta, delta, theta / delta, v)
    neu = neumann(S, degree=NEU_DEGREE, omega=NEU_OMEGA)
    check(neu.fused is True, "neumann() of a card operator did not fuse")
    nchain = neumann(S, degree=NEU_DEGREE, omega=NEU_OMEGA, fused=False)
    nargs = (S, neu.dinv, NEU_DEGREE, NEU_OMEGA, v)
    p, q = CHEB_DEGREE, NEU_DEGREE
    cases = {
        # v read once, y written once, the strips read once; per row the
        # first sweep's v/θ, product, r and d (2·ndiag + 3), each later
        # step's x, r, product and d (2·ndiag + 5), and the last x + d
        "cheb_apply": (
            "cheb", p, cargs, cheb, chain, pa.cheb_apply,
            pa.cheb_apply_torch, pa.cheb_apply_flat_cuda,
            lambda plan: pa.cheb_apply_tiled_cuda(S, plan, *cargs[1:]),
            (2 * n * 8 + strip_bytes,
             n * ((2 * ndiag + 3) + (p - 1) * (2 * ndiag + 5) + 1))),
        # v and D⁻¹ read once, y written once, the strips read once; per row
        # the first sweep's z, product, next z and acc (2·ndiag + 6), each
        # later step's product, z and acc (2·ndiag + 4)
        "neumann_apply": (
            "neumann", q, nargs, neu, nchain, pa.neumann_apply,
            pa.neumann_apply_torch, pa.neumann_apply_flat_cuda,
            lambda plan: pa.neumann_apply_tiled_cuda(S, plan, *nargs[1:]),
            (3 * n * 8 + strip_bytes,
             n * ((2 * ndiag + 6) + (q - 2) * (2 * ndiag + 4)))),
    }
    out = {}
    for name, (kind, degree, args, pre, chain_pre, apply, plain, flat,
               tiled, bound) in cases.items():
        label = f"{kind} p={degree} heat M={HEAT_M}"
        plan = pa.poly_plan(S, kind, degree, torch.float64)
        check(plan is not None, f"{label}: no tile plan")
        y = apply(*args)
        y_flat = flat(*args)
        torch.cuda.synchronize()
        _, rel = _rel_err(pre(v), chain_pre(v))
        check(rel <= POLY_RTOL["float64"],
              f"fused {kind} differs from the chain: {rel:.3e}")
        _, rel_flat = _rel_err(y, y_flat)
        check(rel_flat <= POLY_RTOL["float64"],
              f"{label}: the tiled and flat designs differ by {rel_flat:.3e}")
        t = {
            "design": "tiled",
            "plan": {"tile": [plan.tile_r, plan.tile_c], "halo": plan.sweeps,
                     "tiles": plan.tiles, "smem_bytes": plan.smem_bytes,
                     "blocks_per_sm": plan.blocks_per_sm},
            "ms": _time_cold_ms(lambda: apply(*args)),
            "flat_ms": _time_cold_ms(lambda: flat(*args)),
            "plain_ms": _time_cold_ms(lambda: plain(*args), reps=10),
            "library_ms": None,
            "chain_ms": _time_cold_ms(lambda: chain_pre(v)),
            "warm_ms": _time_ms(lambda: apply(*args)),
            "warm_flat_ms": _time_ms(lambda: flat(*args)),
            "warm_chain_ms": _time_ms(lambda: chain_pre(v)),
            "tiled_equals_flat": bool(torch.equal(y, y_flat)),
        }
        t["bound_ms"], t["bound_by"] = _bound_ms(*bound)
        t["tiles_ms"] = _time_tiles(label, S, kind, degree, tiled, y, plan)
        out[name] = t
        print(f"[poly] {name} at heat M={HEAT_M} (n={n}, f64, L2 flushed): "
              f"tiled kernel {t['ms']:.4f} ms (tile {plan.tile_r}x"
              f"{plan.tile_c}, halo {plan.sweeps}), flat kernel "
              f"{t['flat_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; tiled at {t['bound_ms'] / t['ms']:.1%} of "
              f"it, flat at {t['bound_ms'] / t['flat_ms']:.1%}), plain twin "
              f"{t['plain_ms']:.4f} ms, unfused chain {t['chain_ms']:.4f} ms; "
              f"tiled against flat max|dy|/max|y| {rel_flat:.1e} (bit-equal: "
              f"{t['tiled_equals_flat']}); back to back with operands in L2: "
              f"tiled {t['warm_ms']:.4f} ms, flat {t['warm_flat_ms']:.4f} ms, "
              f"chain {t['warm_chain_ms']:.4f} ms")
    return out


def _check_counts(tag, got, rec, keys):
    for key in keys:
        check(_within_one(got, rec, key),
              f"{tag} {key} {got.get(key)} vs record {rec.get(key)}")


def _check_bounds(tag, pre, rec):
    for key in ("lmin", "lmax"):
        if key in rec:
            got = float(getattr(pre, key))
            print(f"{tag} {key} {got!r} (record {rec[key]!r})")
            check(math.isclose(got, rec[key], rel_tol=BOUNDS_RTOL),
                  f"{tag} {key} {got!r} vs record {rec[key]!r}")


def phase_poly_rows(record):
    """The third slice's main path: the heat M=1024 TimedSolve row through
    ``time_cgmres`` with each polynomial pre-builder, then one more GMRES
    and CGMRES pair for the launches per solve and the iterates.  Returns
    the launches over each row."""
    import warnings

    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        time_cgmres,
    )

    rows = {}
    for short, builder in _poly_builders().items():
        name = f"heat_M{HEAT_M}_{short}"
        rec = record[name]
        tag = f"[{name}]"
        seen = {}

        def pre_builder(system, builder=builder):
            seen["system"] = system
            seen["pre"] = builder(system)
            return seen["pre"]

        _reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = time_cgmres("heat", M=HEAT_M, k=HEAT_K, tol=HEAT_TOL,
                              pre_builder=pre_builder, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows[name] = launches = _read_launches()
        s, pre = seen["system"], seen["pre"]
        print(f"{tag} time_cgmres wall {wall:.3f} s (assembly, two builds, "
              f"warm-up and timed solves); build first "
              f"{out['time_pre_first']:.4f} s, second {out['time_pre']:.4f} s")
        print(f"{tag} {type(pre).__name__} fused={pre.fused} degree "
              f"{pre.degree}")
        _check_bounds(tag, pre, rec)
        print(f"{tag} gmres: steps {out['gmres_steps']} (record "
              f"{rec['gmres']['steps']}), wall {out['time_gmres']:.4f} s, "
              f"{1e3 * out['time_gmres'] / max(out['gmres_steps'], 1):.3f} "
              f"ms/iteration, final residual {out['gmres_res_final']:.6e} "
              f"(record {rec['gmres']['res']:.6e})")
        print(f"{tag} cgmres: steps {out['steps']} (record "
              f"{rec['cgmres']['steps']}), constrained "
              f"{out['constrained_steps']} (record "
              f"{rec['cgmres']['constrained_steps']}), safety {out['safety']} "
              f"(record {rec['cgmres']['safety']}), wall {out['runtime']:.4f} "
              f"s; phase 1 {1e3 * out['iter_time_unconstrained']:.3f} "
              f"ms/iteration, catch-up {1e3 * out['constraint_building']:.3f} "
              f"ms, endgame {1e3 * out['iter_time_constrained']:.3f} "
              f"ms/iteration; final residual {out['res_final']:.6e} (record "
              f"{rec['cgmres']['res']:.6e})")
        for w in caught:
            print(f"{tag} warning ({w.category.__name__}): {w.message}")
        print(f"{tag} launches over the TimedSolve row: {launches}")

        per_solve = {}
        for solver, call in (("gmres", wrappers.gmres_wrapper),
                             ("cgmres", wrappers.cgmres_wrapper)):
            _reset_launches()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                x, info = call(s, k=HEAT_K, tol=HEAT_TOL, pre=pre)
            torch.cuda.synchronize()
            per_solve[solver] = (x, info)
            print(f"{tag} one {solver} solve: {info['steps']} steps, "
                  f"launches {_read_launches()}")
        xg, ig = per_solve["gmres"]
        xc, ic = per_solve["cgmres"]
        res_g = float(torch.linalg.norm(s.b - s.A @ xg))
        res_c = float(torch.linalg.norm(s.b - s.A @ xc))
        print(f"{tag} true residuals: gmres {res_g:.6e} (record "
              f"{rec['gmres']['true_residual']:.6e}), cgmres {res_c:.6e} "
              f"(record {rec['cgmres']['true_residual']:.6e}); cgmres KKT "
              f"deviation {ic['deviation']:.3e} (record "
              f"{rec['cgmres']['deviation']:.3e}, not certified)")
        print(f"{tag} invariant deviations: gmres {_deviations(s, xg)} "
              f"(record {rec['gmres']['deviations']}), cgmres "
              f"{_deviations(s, xc)} (record {rec['cgmres']['deviations']})")

        kernel = "cheb_apply" if short.startswith("cheb") else "neumann_apply"
        check(launches[kernel] > 0, f"{tag} launched no {kernel} kernel")
        _check_tiled(tag, launches, kernel)
        check(pre.fused is True, f"{tag} the builder did not fuse")
        for info in (out, ic):
            check(info["safety"] == rec["cgmres"]["safety"],
                  f"{tag} safety {info['safety']} vs record "
                  f"{rec['cgmres']['safety']}")
            _check_counts(tag + " cgmres", info, rec["cgmres"],
                          ("steps", "constrained_steps"))
        for steps in (out["gmres_steps"], ig["steps"]):
            check(abs(steps - rec["gmres"]["steps"]) <= 1,
                  f"{tag} gmres steps {steps} vs record {rec['gmres']['steps']}")
        check(math.isclose(res_g, rec["gmres"]["true_residual"],
                           rel_tol=RESIDUAL_RTOL),
              f"{tag} gmres true residual {res_g:.6e} vs record "
              f"{rec['gmres']['true_residual']:.6e}")
        for x in (xg, xc):
            check(x.shape == s.b.shape and bool(torch.isfinite(x).all()),
                  f"{tag} iterate is not finite")
        del s, pre, seen
    return rows


def phase_poly_anchors(record):
    """The certified anchors of the third slice, through the wrappers with
    the port's builders.  Returns the launches per anchor."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.models import heat

    builders = _poly_builders()
    out = {}
    for name, M, k, short in ANCHORS:
        rec = record[name]
        tag = f"[{name}]"
        s = heat.linforms(M=M, device=DEVICE)
        _reset_launches()
        pre = builders[short](s)
        xg, ig = wrappers.gmres_wrapper(s, k=k, tol=HEAT_TOL, pre=pre)
        xc, ic = wrappers.cgmres_wrapper(s, k=k, tol=HEAT_TOL, pre=pre)
        torch.cuda.synchronize()
        out[name] = _read_launches()
        _check_bounds(tag, pre, rec)
        res_g = float(torch.linalg.norm(s.b - s.A @ xg))
        res_c = float(torch.linalg.norm(s.b - s.A @ xc))
        dev = _deviations(s, xc)
        print(f"{tag} gmres {ig['steps']} steps (record "
              f"{rec['gmres']['steps']}), true residual {res_g:.4e} (record "
              f"{rec['gmres']['true_residual']:.4e}); cgmres {ic['steps']} "
              f"steps, {ic['constrained_steps']} constrained, safety "
              f"{ic['safety']} (record {rec['cgmres']['steps']} / "
              f"{rec['cgmres']['constrained_steps']} / "
              f"{rec['cgmres']['safety']}), KKT deviation "
              f"{ic['deviation']:.3e} (record {rec['cgmres']['deviation']:.3e}),"
              f" true residual {res_c:.4e} (record "
              f"{rec['cgmres']['true_residual']:.4e}), invariant deviations "
              f"{dev}; launches {out[name]}")
        check(pre.fused is True, f"{tag} the builder did not fuse")
        kernel = "cheb_apply" if short.startswith("cheb") else "neumann_apply"
        check(out[name][kernel] > 0, f"{tag} launched no {kernel} kernel")
        _check_tiled(tag, out[name], kernel)
        check(abs(ig["steps"] - rec["gmres"]["steps"]) <= 1,
              f"{tag} gmres steps {ig['steps']} vs record")
        _check_counts(tag + " cgmres", ic, rec["cgmres"],
                      ("steps", "constrained_steps"))
        check(ic["safety"] == rec["cgmres"]["safety"] is True,
              f"{tag} safety {ic['safety']} vs record")
        check(ic["deviation"] <= DEVIATION_MAX
              and max(abs(d) for d in dev.values()) <= DEVIATION_MAX,
              f"{tag} not certified: KKT {ic['deviation']:.3e}, {dev}")
        if rec["cgmres"]["true_residual"] < HEAT_TOL:  # converged anchors
            check(res_c < HEAT_TOL, f"{tag} cgmres true residual {res_c:.3e}")
        check(bool(torch.isfinite(xc).all()), f"{tag} iterate is not finite")
    return out


def phase_ortho_kernel():
    """Kernel #5 against its plain twin in f64 and f32 at every basis size
    and width of the paths, two launches on the same input bit-equal.
    Returns the largest f64 absolute error."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import ortho

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    max_abs = 0.0
    for n in (SWE_N, HEAT_N, 1000):
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).split(".")[-1]
            for m in ORTHO_ROWS:
                Q = torch.randn(m, n, generator=gen, device=DEVICE, dtype=dtype)
                w = torch.randn(n, generator=gen, device=DEVICE, dtype=dtype)
                h = torch.randn(m, generator=gen, device=DEVICE, dtype=dtype)
                w1, u2 = ortho.fused_update_matvec(Q, w, h)
                w1b, u2b = ortho.fused_update_matvec(Q, w, h)
                torch.cuda.synchronize()
                ref_w1, ref_u2 = ortho.fused_update_matvec_torch(Q, w, h)
                err_w1, rel_w1 = _rel_err(w1, ref_w1)
                err_u2, rel_u2 = _rel_err(u2, ref_u2)
                same = torch.equal(w1, w1b) and torch.equal(u2, u2b)
                print(f"[ortho] m={m} n={n} {tag}: max|dw1|/max|w1| = "
                      f"{rel_w1:.3e}, max|du2|/max|u2| = {rel_u2:.3e} (bound "
                      f"{ORTHO_RTOL[tag]:.0e}); repeated launch bit-equal "
                      f"{same}")
                check(math.isfinite(rel_w1) and math.isfinite(rel_u2)
                      and max(rel_w1, rel_u2) <= ORTHO_RTOL[tag],
                      f"fused CGS2 kernel disagrees with plain at m={m} n={n} "
                      f"{tag}: {rel_w1:.3e}, {rel_u2:.3e}")
                check(same, f"fused CGS2 kernel not deterministic at m={m} "
                            f"n={n} {tag}")
                if dtype == torch.float64:
                    max_abs = max(max_abs, err_w1, err_u2)
                del Q
    return max_abs


def phase_ortho_timing():
    """Kernel #5 in f64 with L2 flushed at the paths' shapes, beside its
    bound and its plain twin, which is the unfused pair of cuBLAS products
    (``w − h @ Q``, then ``Q @ w1``).  Returns the report's fields of each
    shape, the swe M=512, m = 21 one first."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import ortho

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    out = {}
    for label, n, m in ((f"swe_M{SWE_M}_m21", SWE_N, 21),
                        (f"swe_M{SWE_M}_m61", SWE_N, 61),
                        (f"heat_M{HEAT_M}_m21", HEAT_N, 21)):
        Q = torch.randn(m, n, generator=gen, device=DEVICE, dtype=torch.float64)
        w = torch.randn(n, generator=gen, device=DEVICE, dtype=torch.float64)
        h = Q @ w
        pair = _time_cold_ms(lambda: ortho.fused_update_matvec_torch(Q, w, h))
        t = {
            "ms": _time_cold_ms(lambda: ortho.fused_update_matvec(Q, w, h)),
            "plain_ms": pair, "chain_ms": pair, "library_ms": None,
            "warm_ms": _time_ms(lambda: ortho.fused_update_matvec(Q, w, h)),
            "warm_chain_ms": _time_ms(
                lambda: ortho.fused_update_matvec_torch(Q, w, h)),
        }
        # Q and w read once, w1 written once; a multiply-add per entry of Q
        # in each of the two products
        nbytes = (m * n + 2 * n) * 8
        t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, 4 * m * n)
        print(f"[ortho] fused CGS2 update at {label} (n={n}, m={m}, f64, L2 "
              f"flushed): kernel {t['ms']:.4f} ms ({nbytes / t['ms'] / 1e6:.0f}"
              f" GB/s of {nbytes / 1e6:.1f} MB), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; kernel at {t['bound_ms'] / t['ms']:.1%} of "
              f"it), plain twin = unfused cuBLAS pair {pair:.4f} ms; back to "
              f"back with operands in L2: kernel {t['warm_ms']:.4f} ms, pair "
              f"{t['warm_chain_ms']:.4f} ms")
        out[label] = t
        del Q
    return out


def _ortho_launches():
    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv_cuda,
    )
    from structurepreservingiterativesolvers_torch.kernels.ortho import (
        fused_update_matvec_cuda,
    )

    return {"dia_spmv": dia_spmv_cuda, "fused_update_matvec": fused_update_matvec_cuda}


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def phase_swe_fused(s, record):
    """The first slice's swe M=512 row with the fused orthogonalisation:
    GMRES and CGMRES through the wrappers.  Returns the launches over it."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers

    tag = f"[swe M={SWE_M} cgs2_fused]"
    kw = dict(k=SWE_K, tol=SWE_TOL, ortho="cgs2_fused")
    counters = _ortho_launches()
    _zero(counters)
    t0 = time.perf_counter()
    xg, ig = wrappers.gmres_wrapper(s, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    xc, ic = wrappers.cgmres_wrapper(s, timing=True, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _counts(counters)
    rec = record["swe_M512"]
    t = ic["timings"]
    print(f"{tag} gmres: steps {ig['steps']} (record {rec['gmres']['steps']}), "
          f"wall {t1 - t0:.4f} s, {1e3 * (t1 - t0) / max(ig['steps'], 1):.3f} "
          f"ms/iteration; cgmres: steps {ic['steps']} (record "
          f"{rec['cgmres']['steps']}), constrained {ic['constrained_steps']} "
          f"(record {rec['cgmres']['constrained_steps']}), safety "
          f"{ic['safety']}, deviation {ic['deviation']:.3e}, wall "
          f"{t2 - t1:.4f} s, phase 1 {1e3 * t['iter_time_unconstrained']:.3f} "
          f"ms/iteration")
    print(f"{tag} launches over both solves: {launches}")
    res_c = float(torch.linalg.norm(s.b - s.A @ xc))
    print(f"{tag} cgmres true residual {res_c:.4e} (record "
          f"{rec['cgmres']['true_residual']:.4e}), invariant deviations "
          f"{_deviations(s, xc)}")
    check(ic["safety"] is True, f"{tag} CGMRES safety is not True")
    check(ic["deviation"] <= DEVIATION_MAX,
          f"{tag} CGMRES deviation {ic['deviation']:.3e}")
    check(math.isfinite(res_c) and res_c < SWE_TOL,
          f"{tag} CGMRES true residual {res_c:.3e}")
    _check_counts(tag + " cgmres", ic, rec["cgmres"],
                  ("steps", "constrained_steps"))
    check(_within_one(ig, rec["gmres"], "steps"),
          f"{tag} gmres steps {ig['steps']} vs record {rec['gmres']['steps']}")
    check(launches["fused_update_matvec"] == ig["steps"] + ic["steps"],
          f"{tag} kernel #5 launched {launches['fused_update_matvec']} times "
          f"over {ig['steps'] + ic['steps']} Arnoldi steps")
    return launches


def phase_snc_row(record):
    """The fourth slice's main path: the swe M=512 TimedSolve row through
    ``time_cgmres`` with the default pre-builder and the fused
    orthogonalisation, then one more GMRES and CGMRES pair for the launches
    per solve and the iterate.  Returns the launches over the row and the
    row's numbers."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
        time_cgmres,
    )

    name = f"swe_M{SWE_M}_snc"
    rec = record[name]
    tag = f"[{name}]"
    seen = {}

    def pre_builder(system):  # the default, keeping what it was given
        seen["system"] = system
        seen["pre"] = default_pre_builder("swe")(system)
        return seen["pre"]

    counters = _ortho_launches()
    _zero(counters)
    t0 = time.perf_counter()
    out = time_cgmres("swe", M=SWE_M, k=SNC_K, tol=SNC_TOL,
                      pre_builder=pre_builder, ortho="cgs2_fused",
                      device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    s, pre = seen["system"], seen["pre"]
    print(f"{tag} time_cgmres wall {wall:.3f} s (assembly, two builds, "
          f"warm-up and timed solves); build first {out['time_pre_first']:.4f}"
          f" s, second {out['time_pre']:.4f} s; {type(pre).__name__} degree "
          f"{pre.degree} (record {rec['degree']}), {2 * pre.degree + 1} "
          f"products per apply; warm-up pass {out['compile_time']:.4f} s")
    _check_bounds(tag, pre, rec)
    print(f"{tag} gmres: steps {out['gmres_steps']} (record "
          f"{rec['gmres']['steps']}), wall {out['time_gmres']:.4f} s, "
          f"{1e3 * out['time_gmres'] / max(out['gmres_steps'], 1):.3f} "
          f"ms/iteration, final residual {out['gmres_res_final']:.4e}")
    print(f"{tag} cgmres: steps {out['steps']} (record "
          f"{rec['cgmres']['steps']}), constrained {out['constrained_steps']} "
          f"(record {rec['cgmres']['constrained_steps']}), safety "
          f"{out['safety']}, wall {out['runtime']:.4f} s (CGMRES/GMRES "
          f"{out['runtime'] / out['time_gmres']:.3f}); phase 1 "
          f"{1e3 * out['iter_time_unconstrained']:.3f} ms/iteration over "
          f"{out['phase1_steps_measured']}, catch-up "
          f"{1e3 * out['constraint_building']:.3f} ms, endgame "
          f"{1e3 * out['iter_time_constrained']:.3f} ms/iteration; final "
          f"residual {out['res_final']:.4e}")
    con = out["conservation"]
    for nm in out["invariant_names"]:
        gain = max(con[f"gmres_{nm}"], 1e-16) / max(con[f"cgmres_{nm}"], 1e-16)
        print(f"{tag} {nm}: deviation gmres {con[f'gmres_{nm}']:.3e}, cgmres "
              f"{con[f'cgmres_{nm}']:.3e}, gain {gain:.3e}, floor-dominated "
              f"{con[f'floor_{nm}']}")
    print(f"{tag} launches over the TimedSolve row: {launches}")

    per_solve = {}
    for solver, call in (("gmres", wrappers.gmres_wrapper),
                         ("cgmres", wrappers.cgmres_wrapper)):
        _zero(counters)
        x, info = call(s, k=SNC_K, tol=SNC_TOL, pre=pre, ortho="cgs2_fused")
        torch.cuda.synchronize()
        per_solve[solver] = (x, info)
        print(f"{tag} one {solver} solve: {info['steps']} steps, launches "
              f"{_counts(counters)}")
    xg, ig = per_solve["gmres"]
    xc, ic = per_solve["cgmres"]
    res_c = float(torch.linalg.norm(s.b - s.A @ xc))
    print(f"{tag} cgmres true residual {res_c:.4e} (record "
          f"{rec['cgmres']['true_residual']:.4e}), KKT deviation "
          f"{ic['deviation']:.3e} (record {rec['cgmres']['deviation']:.3e}), "
          f"invariant deviations {_deviations(s, xc)}")

    check(launches["dia_spmv"] > 0 and launches["fused_update_matvec"] > 0,
          f"{tag} did not go through kernels #1 and #5: {launches}")
    check(pre.degree == rec["degree"],
          f"{tag} degree {pre.degree} vs record {rec['degree']}")
    for info in (out, ic):
        check(info["safety"] is True, f"{tag} CGMRES safety is not True")
        _check_counts(tag + " cgmres", info, rec["cgmres"],
                      ("steps", "constrained_steps"))
    for steps in (out["gmres_steps"], ig["steps"]):
        check(abs(steps - rec["gmres"]["steps"]) <= 1,
              f"{tag} gmres steps {steps} vs record {rec['gmres']['steps']}")
    check(ic["deviation"] <= DEVIATION_MAX,
          f"{tag} CGMRES KKT deviation {ic['deviation']:.3e}")
    for nm in out["invariant_names"]:
        check(con[f"floor_{nm}"]
              or 2.0 * con[f"cgmres_{nm}"] <= con[f"gmres_{nm}"],
              f"{tag} no 2x gain on {nm} and not floor-dominated: {con}")
    check(math.isfinite(res_c) and res_c < SNC_TOL,
          f"{tag} CGMRES true residual {res_c:.3e}")
    check(xc.shape == s.b.shape and bool(torch.isfinite(xc).all()),
          f"{tag} CGMRES iterate is not finite")
    return launches, out


def phase_snc_evolve(record):
    """The Evolve path at full width: three steps of swe M=512 with the
    skew-normal Chebyshev built on a system of the same N and T, CGMRES with
    the fused orthogonalisation.  Returns the launches and the wall of each
    step."""
    import functools

    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import swe

    name = f"swe_M{SWE_M}_snc_evolve"
    rec = record[name]
    tag = f"[{name}]"
    params = dict(M=SWE_M, N=EVOLVE_N, T=EVOLVE_T)
    pre = default_pre_builder("swe")(swe.linforms(device=DEVICE, **params))
    _check_bounds(tag, pre, rec)
    check(pre.degree == rec["degree"],
          f"{tag} degree {pre.degree} vs record {rec['degree']}")
    solve = functools.partial(wrappers.cgmres_wrapper, ortho="cgs2_fused")
    starts = []

    def solver(system, **kw):  # the start of each step's solve
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return solve(system, **kw)

    counters = _ortho_launches()
    _zero(counters)
    t0 = time.perf_counter()
    out = evolve("swe", k=SNC_K, tol=SNC_TOL, pre=pre, device=DEVICE,
                 solver=solver, **params)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = _counts(counters)
    # a step: its solve, the host read of the invariants and the next
    # system's step_update, from one solve's start to the next's
    step_walls = [b - a for a, b in zip(starts, starts[1:] + [t_end])]
    e0 = abs(out["energy"][0])
    print(f"{tag} evolve wall {t_end - t0:.3f} s, of it assembly "
          f"{starts[0] - t0:.3f} s and {EVOLVE_N} steps of "
          f"{', '.join(f'{1e3 * w:.3f}' for w in step_walls)} ms; steps "
          f"{out['steps']} (record {rec['steps']}), constrained "
          f"{out['constrained_steps']} (record {rec['constrained_steps']}), "
          f"safety {out['safety']}")
    print(f"{tag} drift dm {[float(d) for d in out['dm']]} (record "
          f"{rec['drift']['dm']}), de/|e0| {[float(d / e0) for d in out['de']]}")
    print(f"{tag} launches over the evolution: {launches}")
    check(launches["dia_spmv"] > 0 and launches["fused_update_matvec"] > 0,
          f"{tag} did not go through kernels #1 and #5: {launches}")
    check(len(out["steps"]) == EVOLVE_N, f"{tag} ran {len(out['steps'])} steps")
    for got, want in zip(out["steps"], rec["steps"]):
        check(abs(got - want) <= 1, f"{tag} steps {out['steps']} vs record "
                                    f"{rec['steps']}")
    check(all(sf is True for sf in out["safety"]),
          f"{tag} safety {out['safety']}")
    # the bars of tests/test_experiments.py::test_fused_evolve_swe
    check(all(d < 1e-9 for d in out["dm"]), f"{tag} mass drift {out['dm']}")
    check(all(d / e0 < 1e-13 for d in out["de"]),
          f"{tag} energy drift {out['de']}")
    check(bool(torch.isfinite(out["sol"]).all()), f"{tag} solution not finite")
    return launches, step_walls


def main() -> int:
    if not all((PACKAGE / "csrc" / src).is_file() for src in SOURCES):
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
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from structurepreservingiterativesolvers_torch.models import heat, lkdv, swe

    records = {name: json.loads((PACKAGE / "reference" / name).read_text())
               for name in ("slice1.json", "slice2.json", "slice3.json",
                            "slice4.json")}
    t_start = time.perf_counter()
    phase_build()
    t0 = time.perf_counter()
    swe_sys = swe.linforms(M=SWE_M, device=DEVICE)
    print(f"[swe M={SWE_M}] assembly {time.perf_counter() - t0:.2f} s")
    dia_err = phase_kernel(swe_sys, lkdv.linforms(M=100, degree=3,
                                                  device=DEVICE))
    torch.cuda.synchronize()
    poly_err = phase_poly_kernels({f"swe M={SWE_M}": swe_sys.A})
    torch.cuda.synchronize()
    phase_lkdv(records["slice1.json"])
    torch.cuda.synchronize()
    swe_launches = phase_swe(swe_sys, records["slice1.json"])
    torch.cuda.synchronize()
    ortho_err = phase_ortho_kernel()
    ortho_times = phase_ortho_timing()
    torch.cuda.synchronize()
    fused_launches = phase_swe_fused(swe_sys, records["slice1.json"])
    torch.cuda.synchronize()
    del swe_sys
    heat_sys, pre, launches = phase_heat(records["slice2.json"])
    torch.cuda.synchronize()
    st_err, st, dia_heat_err, dia = phase_heat_kernels(heat_sys, pre)
    torch.cuda.synchronize()
    small = heat.linforms(M=16, device=DEVICE)
    for name, err in phase_poly_kernels(
            {f"heat M={HEAT_M}": heat_sys.A, "heat M=16": small.A},
            {"heat M=16": [("cheb", 1), ("cheb", 2), ("cheb", CHEB_DEGREE),
                           ("neumann", 1), ("neumann", 2), ("neumann", 3),
                           ("neumann", NEU_DEGREE)]}).items():
        poly_err[name] = max(poly_err[name], err)
    poly_times = phase_poly_timing(heat_sys)
    torch.cuda.synchronize()
    del heat_sys, pre, small
    rows = phase_poly_rows(records["slice3.json"])
    torch.cuda.synchronize()
    anchors = phase_poly_anchors(records["slice3.json"])
    torch.cuda.synchronize()
    snc_launches, _ = phase_snc_row(records["slice4.json"])
    torch.cuda.synchronize()
    evolve_launches, _ = phase_snc_evolve(records["slice4.json"])
    torch.cuda.synchronize()
    print(f"[env] phases took {time.perf_counter() - t_start:.1f} s")

    tpu = "structurepreservingiterativesolvers_tpu/ops/"
    src = "structurepreservingiterativesolvers_torch/csrc/"
    cheb_row, neu_row = (f"heat_M{HEAT_M}_{short}" for short in ("cheb8", "neu4"))
    swe_paths = {f"swe_M{SWE_M}_cgs2_fused": fused_launches,
                 f"swe_M{SWE_M}_snc": snc_launches,
                 f"swe_M{SWE_M}_snc_evolve": evolve_launches}

    def by_path(name, **first):
        """A kernel's launches on each path that ran it."""
        paths = {**first, **{row: rows[row][name] for row in rows},
                 **{a: anchors[a][name] for a in anchors}}
        return {path: n for path, n in paths.items() if n}

    kernels = [
        {"name": "dia_spmv", "route": "cuda", "source": src + "dia_spmv.cu",
         "replaces": f"{tpu}pallas_spmv.py:91", "launches": launches["dia_spmv"],
         "launches_by_path": by_path("dia_spmv", **{
             f"swe_M{SWE_M}": swe_launches,
             f"heat_M{HEAT_M}": launches["dia_spmv"],
             **{path: n["dia_spmv"] for path, n in swe_paths.items()}}),
         "max_abs_err": max(dia_err, dia_heat_err), **dia},
        {"name": "stencil_spmv", "route": "cuda",
         "source": src + "stencil_spmv.cu",
         "replaces": f"{tpu}pallas_spmv.py:165",
         "launches": launches["stencil_spmv"],
         "launches_by_path": by_path("stencil_spmv", **{
             f"heat_M{HEAT_M}": launches["stencil_spmv"]}),
         "max_abs_err": st_err, **st},
    ]
    for name, row, line in (("cheb_apply", cheb_row, 217),
                            ("neumann_apply", neu_row, 230)):
        t = {key: poly_times[name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "chain_ms", "design", "flat_ms", "plan", "tiles_ms")}
        kernels.append(
            {"name": name, "route": "cuda", "source": src + "poly_tiled.cu",
             "flat_source": src + "poly_apply.cu",
             "replaces": f"{tpu}pallas_poly.py:{line}",
             "launches": rows[row][name],
             "launches_by_design": {
                 design: rows[row][f"{name}_{design}"]
                 for design in ("tiled", "flat")},
             "launches_by_path": by_path(name), "max_abs_err": poly_err[name],
             **t})
    head = f"swe_M{SWE_M}_m21"  # the row's basis at k=20 is 21 rows at most
    kernels.append(
        {"name": "fused_update_matvec", "route": "cuda",
         "source": src + "ortho_fused.cu",
         "replaces": f"{tpu}pallas_ortho.py:67",
         "launches": snc_launches["fused_update_matvec"],
         "launches_by_path": {path: n["fused_update_matvec"]
                              for path, n in swe_paths.items()},
         "max_abs_err": ortho_err, "timed_at": head,
         **{key: ortho_times[head][key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "chain_ms")},
         "times": {label: {key: t[key] for key in (
             "ms", "chain_ms", "bound_ms", "warm_ms", "warm_chain_ms")}
             for label, t in ortho_times.items()}})
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
