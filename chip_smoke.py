#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; JAX is neither needed nor
imported.  Phases, each of which raises on a failed check:

1. build the six kernel sources from ``csrc/`` (``dia_spmv.cu``,
   ``stencil_spmv.cu``, ``poly_apply.cu``, ``poly_tiled.cu``,
   ``ortho_fused.cu``, ``dia_spmm.cu``), one ``nvcc`` for each source,
   started together;
2. hold the DIA kernel against its plain PyTorch twin in f64 and f32 on the
   shallow-water operator (M=512, wrapped) and the lkdv degree-3 M=100
   operators (A wrapped, the mass matrix not, ragged n), through each
   operator's live plan, with the dense design (every diagonal) and
   ``A @ x`` (live where the plan pays, dense elsewhere) giving the same
   bits and two launches bit-equal; then time it at the shallow-water shape
   with L2 flushed: ``A @ x``, the live design (at its chunk and at others),
   the dense design, the plain twin and cuSPARSE, beside the bounds on the
   stored non-zeros, on the live segments and on every diagonal, and the
   host's time per product;
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
   heat M=1024, M=16 and M=17 operators in its tiled design, which must
   give the flat design's bits, two launches bit-equal, and the DIA kernel
   on heat's matrices and every operator of the AMG hierarchy, whose plans
   do not pay; time what the AMG's live plans cost to build; and time both
   kernels (the stencil's tiled design at its tile and at every tile, and
   its flat one, through the same dispatcher; the DIA's ``A @ x``, live and
   dense designs), their plain twins and one cuSPARSE CSR matvec of the
   same matrix at the heat M=1024 shape, with the L2 cache flushed before
   each launch, beside the least time the card could take, and the host's
   time per stencil product;
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
    so dt = 0.1 as in the row), counting kernels #1 and #5 over each;
13. the seventh slice, lkdvRK at the reference's error-sweep grid (M=400,
    N=10), held to ``reference/slice7.json``: kernel #1 against its plain
    twin in f64 and f32 on the (3, 2) row's stage operator (42 wrapped
    diagonals, n = 9,600), with its live share, the design ``A @ x`` picks
    and its L2-flushed times beside the bound and cuSPARSE CSR;
14. each grid row, (3, 2, 1e-3), (4, 3, 1e-5) and (5, 4, 1e-7), through
    ``time_cgmres`` with the default lkdvRK pre-builder (RAS over 5 blocks
    with a degree-3 Neumann acceleration, inverses built on the host): the
    format and width of A, the block shape, the steps, safety and
    deviation, ``time_pre``, the walls, and the composite's device time per
    apply beside its byte bound; the (3, 2) row once more with
    ``ortho="cgs2_fused"``, kernel #5 on the stage system;
15. one evolution of the error sweep on the card,
    ``error_sweep.run_single("CGMRES", 3, 2, 1e-3, N=10, M=400)``: its
    steps and drifts against the record's, its L2 error series against the
    same evolution by the plain twins on the host's CPU (within max(1e-6,
    10× the JAX package's own drift of that series under a 1e-15 change of
    b, in the record)) with its distance from the record printed, and each
    step's wall;
16. CGMRES on lkdv M=100, degree 3 with the energy as a
    ``GeneralConstraint``, whose Taylor models differentiate through kernel
    #1: it must certify and match the quadratic path.

17. (after phase 11) the eighth slice's device core, ``cgmres(loop="while")``,
    on the first slice's swe M=512 row with ``cgs2`` and ``cgs2_fused``:
    each step a CUDA graph, captured on first use and replayed; held to
    ``reference/slice1.json`` (steps within one, safety, KKT deviation, true
    residual), to the host loop on the card (x within 1e-10) and to the
    eager device core on the card (within 1e-13); kernels #1 and #5 inside
    the replays by the counters (launches per capture times replays) and by
    the profiler's kernel names; the median wall of 5 solves of each loop,
    ``time_capture``, device busy and idle share;
18. (after phase 12) ``fused_evolve`` on the swe M=512 Evolve row: started
    from zero against ``swe_M512_snc_evolve`` and warm-started against the
    JAX ``fused_evolve`` record ``swe_M512_snc_fused``
    (``reference/slice8.json``), with each step's wall beside the host-loop
    evolution's, ``time_capture`` and the idle share of a profiled
    evolution;
19. (last) the ninth and tenth slices: the batched DIA kernel
    (``dia_spmm.cu``) against its plain twin within 1e-12 on swe M=512's A
    at B = 1, 2, 3, 8, 41, on heat M=1024's A (after phase 6) and on lkdvRK
    (3, 2)'s A (after phase 13) at B = 8, and at the catch-up's shapes: lkdv
    M=100's mass matrix (after phase 3), heat M=1024's ``Emat`` (after
    phase 5) and lkdvRK (3, 2)'s mass matrix (after phase 14), each at the
    widest block its path gave the kernel and read as the catch-up reads it;
    in the design ``spmm_plan`` picks and in both designs forced (tile,
    spread), bit-equal to each other, to a second launch, across layouts
    (a view, a contiguous block, rows at an odd stride) and column by
    column to kernel #1; each shape timed in both designs beside B launches
    of kernel #1, cuSPARSE SpMM, the plain twin and the bound, and the
    widest swe block beside three yardsticks of what holds it back (a copy
    of its vectors, its tiles as launches of their own, the same operator
    with its far offsets folded near); every batched launch of every path is noted with its
    shape and design, and the lkdv hard solve runs on the device core too,
    whose catch-up graph holds the batched kernel; then ``cgmres_many`` on the two swe
    M=512 rows of ``reference/slice9.json`` at B = 8, each item held to
    the JAX package with its targets summed as the port sums them (steps
    equal), to the record (safety, the residual trace before the first
    gate opens, x's max-norm and sum, and where the record certifies the
    KKT deviation and true residual) and to its own
    ``cgmres(loop="while")`` on the card (steps equal, x within 1e-10);
    the median wall of 5 batched solves beside the 8 single solves,
    ``time_capture``, device busy and idle share, and the batched kernel
    inside the replays by the counters (in the design its plan picks) and
    the profiler.

Every main path checks, by the launch counters, that its DIA products ran
the design its operators' plans pick (live on swe, dense on heat; on an
lkdvRK row the design of A's and the mass matrix's plans where they agree,
else only that kernel #1 ran) and its stencil products the tiled one.  The line before
the last is the kernel report as JSON; the last line is the device record.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout.
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
           "ortho_fused.cu", "dia_spmm.cu")
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


def _host_us(fn, reps=500):
    """Microseconds of the host's time per call over a run of calls that
    the card runs faster than the host issues them, so the host never
    waits: what a call costs the host, Python and launch included."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


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


def _check_dia(label, A, gen, dtypes=("float64", "float32")):
    """Kernel #1 on the DIA ``A`` against its plain twin in each dtype: the
    live design with A's plan, and the dense design on the same input,
    which must give the same bits; two launches bit-equal; and ``A @ x``,
    which must give them too, in the design the plan picks (live where it
    pays).  Each launch counts in its design and nowhere else.  Returns the
    largest f64 absolute error."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

    max_abs = 0.0
    for tag in dtypes:
        dtype = getattr(torch, tag)
        Ad = A if A.dtype == dtype else A.astype(dtype)
        x = torch.randn(A.shape[0], generator=gen, device=DEVICE, dtype=dtype)
        plan = Ad.live()
        before = (kd.dia_spmv_live_cuda.launches,
                  kd.dia_spmv_dense_cuda.launches)
        y = kd.dia_spmv_live_cuda(Ad.data, Ad.offsets, Ad.wrap, plan, x)
        again = kd.dia_spmv_live_cuda(Ad.data, Ad.offsets, Ad.wrap, plan, x)
        dense = kd.dia_spmv_cuda(Ad.data, Ad.offsets, Ad.wrap, x)
        product = Ad @ x
        torch.cuda.synchronize()
        check((kd.dia_spmv_live_cuda.launches, kd.dia_spmv_dense_cuda.launches)
              == (before[0] + 2 + plan.pays, before[1] + 1 + (not plan.pays)),
              f"DIA {label} {tag}: the launches did not go to their designs")
        abs_err, rel = _rel_err(y, kd.dia_spmv_torch(Ad.data, Ad.offsets,
                                                     Ad.wrap, x))
        live = int(_popcounts(plan.words).sum())
        print(f"[kernel] DIA {label} n={A.shape[0]} ndiag={len(A.offsets)} "
              f"wrap={A.wrap} {tag}: live design max|dy|/max|y| = {rel:.3e} "
              f"(bound {KERNEL_RTOL[tag]:.0e}); live diagonals a chunk "
              f"{live / len(plan.words):.2f} of {len(A.offsets)} (chunk "
              f"{plan.chunk}), live share {plan.share:.4f}, so A @ x runs "
              f"{'live' if plan.pays else 'dense'}; equals the dense design "
              f"{torch.equal(y, dense)}, a second launch "
              f"{torch.equal(y, again)}, A @ x {torch.equal(y, product)}")
        check(math.isfinite(rel) and rel <= KERNEL_RTOL[tag],
              f"DIA kernel disagrees with plain on {label} {tag}: {rel:.3e}")
        check(torch.equal(y, dense) and torch.equal(y, again)
              and torch.equal(y, product),
              f"DIA {label} {tag}: live and dense designs or repeats differ")
        if tag == "float64":
            max_abs = max(max_abs, abs_err)
    return max_abs


def _popcounts(words):
    """The set bits of each int64 word of a live plan."""
    import torch

    bits = torch.arange(64, device=words.device)
    return ((words[:, None] >> bits) & 1).sum(dim=1)


def phase_kernel(swe_sys, lkdv_sys):
    """Kernel #1 against its plain twin in f64 and f32 on the swe M=512 and
    lkdv operators, each through its live plan, beside the dense design;
    then its times at the swe M=512 shape.  Returns the largest f64 error
    and the timing fields of the report."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv,
        dia_spmv_torch,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    max_abs_f64 = 0.0
    for name, A in {"swe_M512_A": swe_sys.A, "lkdv_hard_A": lkdv_sys.A,
                    "lkdv_hard_Mmat": lkdv_sys.Mmat}.items():
        max_abs_f64 = max(max_abs_f64, _check_dia(name, A, gen))

    A = swe_sys.A
    x = torch.randn(A.shape[0], generator=gen, device=DEVICE, dtype=torch.float64)
    check(A.live().pays, "the swe M=512 operator's plan does not pay")
    ms = _time_ms(lambda: A @ x)
    plain_ms = _time_ms(lambda: dia_spmv_torch(A.data, A.offsets, A.wrap, x),
                        reps=50)
    dense_ms = _time_ms(lambda: dia_spmv(A.data, A.offsets, A.wrap, x))
    # the host's time per product: through the operator's kept launch, and
    # through the raw wrapper, which checks and resolves it on every call
    plan = A.live()
    host = {"A @ x": _host_us(lambda: A @ x),
            "resolved per call": _host_us(
                lambda: dia_spmv(A.data, A.offsets, A.wrap, x, plan))}
    print(f"[kernel] swe M=512 f64 SpMV back to back with x in L2: live "
          f"design {ms:.4f} ms, dense design {dense_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; the host's time per call: " + ", ".join(
              f"{k} {t:.2f} us" for k, t in host.items()))
    out = _time_dia(A, swe_sys.A_csr, x, "swe M=512")
    out["host_us"] = host
    return max_abs_f64, out


def _time_dia(A, A_csr, x, label):
    """Kernel #1 as ``A @ x`` runs it (in the design A's plan picks), the
    live design with the DIA's plan, the same kernel with every bit set (the
    dense read), its plain twin and the cuSPARSE matvec of the same matrix,
    each with L2 flushed, and the live design at other chunk lengths;
    returns the timing fields of the report.  The bound counts the stored
    non-zeros with x and y; the bounds of the live segments and of the dense
    read stand beside it."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

    Acsr = _csr(A_csr)
    n, ndiag = A.shape[0], len(A.offsets)
    plan = A.live()
    out = {
        "design": "live" if plan.pays else "dense",
        "live_share": plan.share,
        "ms": _time_cold_ms(lambda: A @ x),
        "live_ms": _time_cold_ms(
            lambda: kd.dia_spmv_live_cuda(A.data, A.offsets, A.wrap, plan, x)),
        "dense_ms": _time_cold_ms(
            lambda: kd.dia_spmv_cuda(A.data, A.offsets, A.wrap, x)),
        "plain_ms": _time_cold_ms(
            lambda: kd.dia_spmv_torch(A.data, A.offsets, A.wrap, x), reps=20),
        "library_ms": _time_cold_ms(lambda: Acsr @ x),
        "chunk": plan.chunk,
        "chunks_ms": {},
    }
    for chunk in (64, 128, 256, 512, 1024, 4096):
        other = kd.live_plan(A.data, chunk)
        y = kd.dia_spmv_live_cuda(A.data, A.offsets, A.wrap, other, x)
        check(torch.equal(y, A @ x),
              f"DIA {label}: chunk {chunk} changes the bits")
        out["chunks_ms"][str(chunk)] = _time_cold_ms(
            lambda: kd.dia_spmv_live_cuda(A.data, A.offsets, A.wrap, other, x),
            reps=20)
    nnz = int(torch.count_nonzero(A.data))
    rows = _popcounts(plan.words) * plan.chunk
    live_rows = int(rows.sum()) - int(_popcounts(plan.words[-1:]).sum()) * (
        len(plan.words) * plan.chunk - n)  # the ragged last chunk
    # the stored non-zeros (a multiply and an add each), x read once, y
    # written once; the live segments with the plan; every diagonal
    out["bound_ms"], out["bound_by"] = _bound_ms((nnz + 2 * n) * 8, 2 * nnz)
    out["bound_live_ms"], _ = _bound_ms(
        (live_rows + 2 * n) * 8 + len(plan.words) * 8, 2 * live_rows)
    out["bound_dense_ms"], _ = _bound_ms((ndiag + 2) * n * 8, 2 * ndiag * n)
    out["nnz_per_row"] = nnz / n
    out["live_per_row"] = live_rows / n
    print(f"[kernel] DIA SpMV at {label} (n={n}, ndiag={ndiag}, {nnz / n:.2f} "
          f"non-zeros and {live_rows / n:.2f} live diagonals a row, live "
          f"share {plan.share:.4f}, f64, L2 flushed): A @ x "
          f"({out['design']} design) {out['ms']:.4f} ms, live design "
          f"{out['live_ms']:.4f} ms (chunk {plan.chunk}), "
          f"dense design {out['dense_ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, cuSPARSE CSR {out['library_ms']:.4f} "
          f"ms; bound {out['bound_ms']:.4f} ms on the non-zeros "
          f"({out['bound_by']}; A @ x at {out['bound_ms'] / out['ms']:.1%} "
          f"of it, live design at {out['bound_ms'] / out['live_ms']:.1%}), "
          f"{out['bound_live_ms']:.4f} ms on the live segments "
          f"({out['bound_live_ms'] / out['live_ms']:.1%}), "
          f"{out['bound_dense_ms']:.4f} ms on every diagonal (dense design "
          f"at {out['bound_dense_ms'] / out['dense_ms']:.1%})")
    print(f"[kernel] DIA SpMV at {label}, live design by chunk length (L2 "
          f"flushed): " + ", ".join(f"{c}: {t:.4f} ms"
                                   for c, t in out["chunks_ms"].items()))
    return out


def _deviations(system, x):
    from structurepreservingiterativesolvers_torch.experiments import report

    inv = system.compute_invariants(x)
    targets = report._targets(system, list(inv))
    return {k: float(v) - targets[k] for k, v in inv.items()}


def _within_one(info, rec, key):
    return abs(int(info.get(key, 0)) - int(rec.get(key, 0))) <= 1


def phase_lkdv(record):
    """The lkdv SingleSolve and hard configurations, held to the record;
    the hard CGMRES solve again on the device core.  Returns the hard
    system and the launches over its CGMRES solve on each loop."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.single_solve import (
        single_solve,
    )
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
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
    _reset_launches()
    xc, ic = cgmres(s.A, s.b, k=50, tol=1e-6, constraints=s.constraints())
    torch.cuda.synchronize()
    launches = {"lkdv_hard": _read_launches()}
    # the same solve on the device core: its catch-up graph holds the
    # products with the mass matrix, counted by its replays
    cgmres(s.A, s.b, k=50, tol=1e-6, constraints=s.constraints(),
           loop="while")
    _reset_launches()
    xw, iw = cgmres(s.A, s.b, k=50, tol=1e-6, constraints=s.constraints(),
                    loop="while")
    torch.cuda.synchronize()
    launches["lkdv_hard_graph_core"] = _read_launches()
    importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres"
    ).clear_core_cache()
    for path, counts in launches.items():
        print(f"[lkdv hard] {path}: batched kernel {counts['dia_spmm']} "
              f"launches (" + ", ".join(
                  f"{d} {counts[f'dia_spmm_{d}']}" for d in
                  ("live", "dense", *kd.DESIGNS))
              + f"), kernel #1 {counts['dia_spmv']}")
        check(counts["dia_spmm"] > 0 and counts["dia_spmm_spread"]
              == counts["dia_spmm"], f"[lkdv hard] {path}: the catch-up's "
                                     f"products with the mass matrix did not "
                                     f"all run the spread design: {counts}")
    # tol=1e-6 leaves the iterate O(tol) from the solution, so the two
    # loops' rounding moves x by more than roundoff: each is held to the
    # certificate instead
    dw = _deviations(s, xw)
    print(f"[lkdv hard] on the device core: steps {iw['steps']}, safety "
          f"{iw['safety']}, deviations {dw}; x {_rel(xw, xc):.3e} from the "
          f"host loop's")
    check(iw["steps"] == ic["steps"] and iw["safety"] is True
          and max(abs(d) for d in dw.values()) <= DEVIATION_MAX,
          f"lkdv hard on the device core: {iw['steps']} steps (host loop "
          f"{ic['steps']}), safety {iw['safety']}, deviations {dw}")
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
    return s, launches


def phase_swe(s, record):
    """The first slice's path: both solvers at full size, through the
    wrappers a user calls.  Returns the DIA kernel launches counted over
    it."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers

    # one untimed, uncounted pass first: the library set-up of the first
    # large f64 products and the allocator's first blocks are paid there
    t0 = time.perf_counter()
    wrappers.gmres_wrapper(s, k=SWE_K, tol=SWE_TOL)
    wrappers.cgmres_wrapper(s, k=SWE_K, tol=SWE_TOL)
    torch.cuda.synchronize()
    print(f"[swe M={SWE_M}] first pass (GMRES + CGMRES, set-up included) "
          f"{time.perf_counter() - t0:.4f} s")

    _reset_launches()
    t0 = time.perf_counter()
    xg, ig = wrappers.gmres_wrapper(s, k=SWE_K, tol=SWE_TOL)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    xc, ic = wrappers.cgmres_wrapper(s, k=SWE_K, tol=SWE_TOL, timing=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _read_launches()
    launches = counts["dia_spmv"]

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
    _check_design(f"[swe M={SWE_M}]", counts, "dia_spmv")
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

    seen = {}

    def pre_builder(system):  # the default, keeping what it was given
        seen["system"] = system
        seen["pre"] = default_pre_builder("heat")(system)
        return seen["pre"]

    _reset_launches()
    t0 = time.perf_counter()
    out = time_cgmres("heat", M=HEAT_M, k=HEAT_K, tol=HEAT_TOL,
                      pre_builder=pre_builder, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: n for key, n in _read_launches().items()
                if key.startswith(("dia_sp", "stencil_spmv"))}
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
        _reset_launches()
        x, info = call(s, k=HEAT_K, tol=HEAT_TOL, pre=pre)
        torch.cuda.synchronize()
        counts = _read_launches()
        per_solve[name] = (x, info)
        print(f"{tag} one {name} solve: {info['steps']} steps, DIA kernel "
              f"{counts['dia_spmv']} launches ({counts['dia_spmv_dense']} "
              f"dense), stencil kernel {counts['stencil_spmv']} "
              f"({counts['stencil_spmv_tiled']} tiled), batched kernel "
              f"{counts['dia_spmm']} ({counts['dia_spmm_tile']} tile: the "
              f"catch-up's product with Emat)")
        for kernel in ("dia_spmv", "stencil_spmv"):
            _check_design(f"{tag} one {name} solve", counts, kernel,
                          designs=HEAT_DESIGNS)
    xc, ic = per_solve["cgmres"][:2]
    xg, ig = per_solve["gmres"][:2]
    res_c = float(torch.linalg.norm(s.b - s.A @ xc))
    res_g = float(torch.linalg.norm(s.b - s.A @ xg))
    print(f"{tag} true residuals: cgmres {res_c:.4e} (record "
          f"{rec['cgmres']['true_residual']:.4e}), gmres {res_g:.4e} (record "
          f"{rec['gmres']['true_residual']:.4e}); cgmres KKT deviation "
          f"{ic['deviation']:.3e} (record {rec['cgmres']['deviation']:.3e})")
    print(f"{tag} cgmres invariant deviations {_deviations(s, xc)}")

    for kernel in ("dia_spmv", "stencil_spmv"):
        _check_design(tag, launches, kernel, designs=HEAT_DESIGNS)
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


def _check_stencil(label, S, gen, split_tag="float64"):
    """Kernel #2 on the stencil ``S`` against its plain twin in f64 and
    f32, through the dispatch, which must pick the tiled design (S has
    strips within the box), beside the flat design on the same input, which
    must give the same bits; two launches bit-equal; and, in f64, against
    S's explicit operator within the bound of ``split_tag``, the dtype in
    which S was split into its constants and strips.  Returns the largest
    f64 absolute error."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks
    from structurepreservingiterativesolvers_torch.kernels.dia_spmv import (
        dia_spmv_torch,
    )

    check(S.grid_c > 0, f"{label} operator has no strips")
    check(ks.stencil_plan(S.shape[0], S.grid_c, S.offsets, S.wrap)
          is not None, f"{label}: the stencil is not planned tiled")
    max_abs = 0.0
    for dtype in (torch.float64, torch.float32):
        strips = tuple(t.to(dtype) for t in S.strips)
        x = torch.randn(S.shape[0], generator=gen, device=DEVICE, dtype=dtype)
        args = (S.const, S.offsets, S.wrap, S.grid_c, strips, x)
        before = (ks.stencil_spmv_tiled_cuda.launches,
                  ks.stencil_spmv_flat_cuda.launches)
        y = ks.stencil_spmv(*args)
        again = ks.stencil_spmv(*args)
        flat = ks.stencil_spmv_flat_cuda(*args)
        torch.cuda.synchronize()
        check((ks.stencil_spmv_tiled_cuda.launches,
               ks.stencil_spmv_flat_cuda.launches)
              == (before[0] + 2, before[1] + 1),
              f"stencil {label}: the launches did not go to their designs")
        abs_err, rel = _rel_err(y, ks.stencil_spmv_torch(*args))
        tag = str(dtype).split(".")[-1]
        print(f"[kernel] stencil {label} n={S.shape[0]} grid_c={S.grid_c} "
              f"{tag}: tiled design max|dy|/max|y| = {rel:.3e} (bound "
              f"{KERNEL_RTOL[tag]:.0e}); equals the flat design "
              f"{torch.equal(y, flat)}, a second launch "
              f"{torch.equal(y, again)}")
        check(math.isfinite(rel) and rel <= KERNEL_RTOL[tag],
              f"stencil kernel disagrees with plain on {label} {tag}: "
              f"{rel:.3e}")
        check(torch.equal(y, flat) and torch.equal(y, again),
              f"stencil {label} {tag}: tiled and flat designs or repeats "
              f"differ")
        if dtype == torch.float64:
            max_abs = max(max_abs, abs_err)
            # and the decomposition against the explicit operator
            _, rel_d = _rel_err(y, dia_spmv_torch(S.data, S.offsets, S.wrap,
                                                  x))
            check(rel_d <= KERNEL_RTOL[split_tag],
                  f"stencil {label} differs from its DIA: {rel_d:.3e}")
    return max_abs


def _amg_operators(pre):
    """label -> every DIA of the AMG hierarchy: each level's operator and
    smoothers."""
    ops = {}
    for i, L in enumerate(pre.levels):
        ops[f"AMG level-{i} A"] = L.A
        if L.P is not None:
            ops[f"AMG level-{i} S_P"] = L.P.S
            ops[f"AMG level-{i} S_R"] = L.R.S
    return ops


def phase_heat_kernels(s, pre):
    """Both kernels against their plain twins on heat's operators and the
    AMG's, and their times at the heat M=1024 shape.  Returns the report's
    fields."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks
    from structurepreservingiterativesolvers_torch.models import heat

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    stencil_err, dia_err = 0.0, 0.0
    # odd M assembles as a stencil in f32, split into constants and strips
    # with f32 roundings
    odd = heat.linforms(M=17, device=DEVICE, dtype=torch.float32).A
    for label, S, split_tag in (
            (f"heat M={HEAT_M}", s.A, "float64"),
            ("heat M=16", heat.linforms(M=16, device=DEVICE).A, "float64"),
            ("heat M=17", odd.astype(torch.float64), "float32")):
        stencil_err = max(stencil_err,
                          _check_stencil(label, S, gen, split_tag))
    for label, A in {"A": s.A.dia, "Mmat": s.Mmat, "Emat": s.Emat,
                     **_amg_operators(pre)}.items():
        dia_err = max(dia_err, _check_dia(f"heat M={HEAT_M} {label}", A, gen))

    # what the live plans of the AMG hierarchy cost to build: one reduction
    # each and one host read of its live share, on the operators of the
    # setup (time_pre)
    builds = []
    for label, A in _amg_operators(pre).items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kd.live_plan(A.data, kd.live_chunk(A.dtype))
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    print(f"[kernel] live plans of the {len(builds)} AMG operators: "
          f"{1e3 * sum(builds):.3f} ms in all, each built and synchronised "
          f"alone ({', '.join(f'{1e3 * b:.3f}' for b in builds)} ms); the "
          f"setup builds the levels' plans (time_pre), the smoothers' on "
          f"their first product")

    # times at the main path's shapes, f64, L2 flushed before each call
    S = s.A
    n, ndiag = S.shape[0], len(S.offsets)
    R = n // S.grid_c
    x = torch.randn(n, generator=gen, device=DEVICE, dtype=torch.float64)
    args = (S.const, S.offsets, S.wrap, S.grid_c, S.strips, x)
    # both designs through the same dispatcher (``ks.launch``), each resolved
    # once, as the operator keeps its own
    tiled = ks.stencil_launch(*args)
    flat = ks.stencil_launch(*args, design="flat")
    plan = tiled.tile
    check(tiled.design == "tiled", "heat's stencil is not planned tiled")
    Acsr = _csr(s.A_csr)
    st = {
        "design": "tiled",
        "tile": [plan.tx, plan.ty, plan.run],
        "ms": _time_cold_ms(lambda: ks.launch(tiled, x)),
        "flat_ms": _time_cold_ms(lambda: ks.launch(flat, x)),
        "plain_ms": _time_cold_ms(lambda: ks.stencil_spmv_torch(*args),
                                  reps=20),
        "library_ms": _time_cold_ms(lambda: Acsr @ x),
        "tiles_ms": {},
    }
    y = S @ x
    check(torch.equal(y, ks.launch(flat, x)),
          "the stencil's designs differ through the dispatcher")
    for tile in ks.stencil_tiles(n, S.grid_c, tuple(S.offsets), S.wrap):
        key = f"{tile.tx}x{tile.ty}x{tile.run}"
        rec = ks.stencil_launch(*args, design="tiled", tile=tile)
        check(torch.equal(ks.launch(rec, x), y),
              f"stencil tile {key} changes the bits")
        st["tiles_ms"][key] = _time_cold_ms(lambda: ks.launch(rec, x),
                                            reps=20)
    # x read once and y written once, the strips read once
    nbytes = (2 * n + 2 * (S.grid_c + R) * ndiag) * 8
    st["bound_ms"], st["bound_by"] = _bound_ms(nbytes, 2 * ndiag * n)
    # yardsticks of what a launch costs by this timing: a device copy of x
    # into a vector of its size (the bytes of the bound but the strips'),
    # and a launch that moves 8 bytes, the floor of any kernel's time here
    y_copy, tiny = torch.empty_like(x), torch.empty(1, device=DEVICE)
    st["copy_ms"] = _time_cold_ms(lambda: y_copy.copy_(x))
    st["launch_floor_ms"] = _time_cold_ms(lambda: tiny.zero_())
    warm = _time_ms(lambda: ks.launch(tiled, x))
    warm_flat = _time_ms(lambda: ks.launch(flat, x))
    # the host's time per call: through the operator's kept launch, through
    # the dispatcher in each design, and through the raw wrapper, which
    # resolves the launch on every call
    st["host_us"] = {
        "S @ x": _host_us(lambda: S @ x),
        "tiled": _host_us(lambda: ks.launch(tiled, x)),
        "flat": _host_us(lambda: ks.launch(flat, x)),
        "resolved per call": _host_us(lambda: ks.stencil_spmv(*args)),
    }
    _, rel = _rel_err(Acsr @ x, y)
    print(f"[kernel] stencil SpMV at heat M={HEAT_M} (n={n}, ndiag={ndiag}, "
          f"f64, L2 flushed): tiled design {st['ms']:.4f} ms (tile "
          f"{plan.tx}x{plan.ty * plan.run}, runs of {plan.run}; "
          f"{nbytes / st['ms'] / 1e6:.0f} GB/s of {nbytes / 1e6:.2f} MB), "
          f"flat design {st['flat_ms']:.4f} ms, plain {st['plain_ms']:.4f} "
          f"ms, cuSPARSE CSR {st['library_ms']:.4f} ms (max|dy|/max|y| "
          f"{rel:.1e} against the kernel), bound {st['bound_ms']:.4f} ms "
          f"({st['bound_by']}; tiled at {st['bound_ms'] / st['ms']:.1%} of "
          f"it, flat at {st['bound_ms'] / st['flat_ms']:.1%}); a device "
          f"copy of x, the same bytes but the strips', {st['copy_ms']:.4f} "
          f"ms, and a launch that moves 8 bytes {st['launch_floor_ms']:.4f} "
          f"ms by the same timing; back-to-back "
          f"calls through the dispatcher with x in L2: tiled {warm:.4f} ms, "
          f"flat {warm_flat:.4f} ms each (bound by the host's issue rate "
          f"where it exceeds the kernel's time); the host's time per call: "
          + ", ".join(f"{k} {t:.2f} us" for k, t in st["host_us"].items()))
    print(f"[kernel] stencil SpMV at heat M={HEAT_M}, tiled design by tile "
          f"(TXxTYxRUN, L2 flushed): " + ", ".join(
              f"{k}: {t:.4f} ms" for k, t in st["tiles_ms"].items()))
    check(rel <= 1e-13, f"cuSPARSE CSR disagrees with the stencil: {rel:.3e}")
    dia = _time_dia(S.dia, s.A_csr, x, f"heat M={HEAT_M} A")
    dia["plan_build_ms"] = 1e3 * sum(builds)
    return stencil_err, st, dia_err, dia


def _poly_builders():
    """name -> the pre-builder of the third slice, as a user writes it."""
    from structurepreservingiterativesolvers_torch.precond import (
        chebyshev,
        neumann,
    )

    return {"cheb8": lambda s: chebyshev(s.A, degree=CHEB_DEGREE),
            "neu4": lambda s: neumann(s.A, degree=NEU_DEGREE, omega=NEU_OMEGA)}


def _launch_counters():
    """The launch counters of the six kernels by name, and of each design
    of kernels #1 to #4 and #1b (``<name>_<design>``; #1b's by its
    operator's plan, live or dense, and by its own design)."""
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks
    from structurepreservingiterativesolvers_torch.kernels.ortho import (
        fused_update_matvec_cuda,
    )

    return {"dia_spmv": kd.dia_spmv_cuda,
            "dia_spmv_live": kd.dia_spmv_live_cuda,
            "dia_spmv_dense": kd.dia_spmv_dense_cuda,
            "stencil_spmv": ks.stencil_spmv_cuda,
            "stencil_spmv_tiled": ks.stencil_spmv_tiled_cuda,
            "stencil_spmv_flat": ks.stencil_spmv_flat_cuda,
            "cheb_apply": pa.cheb_apply_cuda,
            "cheb_apply_tiled": pa.cheb_apply_tiled_cuda,
            "cheb_apply_flat": pa.cheb_apply_flat_cuda,
            "neumann_apply": pa.neumann_apply_cuda,
            "neumann_apply_tiled": pa.neumann_apply_tiled_cuda,
            "neumann_apply_flat": pa.neumann_apply_flat_cuda,
            "fused_update_matvec": fused_update_matvec_cuda,
            "dia_spmm": kd.dia_spmm_cuda,
            "dia_spmm_live": kd.dia_spmm_live_cuda,
            "dia_spmm_dense": kd.dia_spmm_dense_cuda,
            **{f"dia_spmm_{design}": getattr(kd, f"dia_spmm_{design}_cuda")
               for design in kd.DESIGNS}}


# the design every launch of a kernel on a main path must run, and the other
DESIGNS = {"dia_spmv": ("live", "dense"), "stencil_spmv": ("tiled", "flat"),
           "cheb_apply": ("tiled", "flat"), "neumann_apply": ("tiled", "flat")}
# but heat's DIA operators, live in all but their boundary rows' segments,
# have plans that do not pay, so their products run the dense design
HEAT_DESIGNS = {**DESIGNS, "dia_spmv": ("dense", "live")}


def _check_design(tag, launches, kernel, required=True, designs=DESIGNS):
    """Every launch of ``kernel`` in ``launches`` ran its design of the main
    path (the first of ``designs[kernel]``), and, where ``required``, there
    was one."""
    want, other = designs[kernel]
    good, bad = launches[f"{kernel}_{want}"], launches[f"{kernel}_{other}"]
    print(f"{tag} {kernel} design: {good} {want}, {bad} {other} launches")
    check((launches[kernel] > 0 or not required)
          and good == launches[kernel] and bad == 0,
          f"{tag} {kernel}: {launches[kernel]} launches, {good} {want}")


def _reset_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _launch_counters().items()}


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


def _check_at_most(tag, got, rec, keys):
    """The counts of a solve that pins a linear constraint the JAX
    package's KKT keeps (``solvers/kkt.py::pins``): at most the record's,
    as the device core's are held (lkdvRK's stage-mapped mass is 0 at the
    start to roundoff, its Krylov vectors carry none, and the JAX package's
    endgame stalls on the singular KKT matrix for a few steps)."""
    for key in keys:
        check(int(got.get(key, 0)) <= int(rec.get(key, 0)),
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
        _check_design(tag, launches, kernel)
        _check_design(tag, launches, "stencil_spmv")
        _check_design(tag, launches, "dia_spmv", required=False,
                      designs=HEAT_DESIGNS)
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
        _check_design(tag, out[name], kernel)
        _check_design(tag, out[name], "stencil_spmv")
        _check_design(tag, out[name], "dia_spmv", required=False,
                      designs=HEAT_DESIGNS)
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


def phase_swe_fused(s, record):
    """The first slice's swe M=512 row with the fused orthogonalisation:
    GMRES and CGMRES through the wrappers.  Returns the launches over it."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers

    tag = f"[swe M={SWE_M} cgs2_fused]"
    kw = dict(k=SWE_K, tol=SWE_TOL, ortho="cgs2_fused")
    _reset_launches()
    t0 = time.perf_counter()
    xg, ig = wrappers.gmres_wrapper(s, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    xc, ic = wrappers.cgmres_wrapper(s, timing=True, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _read_launches()
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
    _check_design(tag, launches, "dia_spmv")
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

    _reset_launches()
    t0 = time.perf_counter()
    out = time_cgmres("swe", M=SWE_M, k=SNC_K, tol=SNC_TOL,
                      pre_builder=pre_builder, ortho="cgs2_fused",
                      device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
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
        _reset_launches()
        x, info = call(s, k=SNC_K, tol=SNC_TOL, pre=pre, ortho="cgs2_fused")
        torch.cuda.synchronize()
        per_solve[solver] = (x, info)
        print(f"{tag} one {solver} solve: {info['steps']} steps, launches "
              f"{_read_launches()}")
    xg, ig = per_solve["gmres"]
    xc, ic = per_solve["cgmres"]
    res_c = float(torch.linalg.norm(s.b - s.A @ xc))
    print(f"{tag} cgmres true residual {res_c:.4e} (record "
          f"{rec['cgmres']['true_residual']:.4e}), KKT deviation "
          f"{ic['deviation']:.3e} (record {rec['cgmres']['deviation']:.3e}), "
          f"invariant deviations {_deviations(s, xc)}")

    check(launches["dia_spmv"] > 0 and launches["fused_update_matvec"] > 0,
          f"{tag} did not go through kernels #1 and #5: {launches}")
    _check_design(tag, launches, "dia_spmv")
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

    _reset_launches()
    t0 = time.perf_counter()
    out = evolve("swe", k=SNC_K, tol=SNC_TOL, pre=pre, device=DEVICE,
                 solver=solver, **params)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = _read_launches()
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
    _check_design(tag, launches, "dia_spmv")
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

# the eighth slice: solves timed per path, and the profiler ranges of the
# graph runner (host spans, not device work)
GRAPH_SOLVES = 5


def _is_span(name):
    return (name.startswith("replay ") or name == "flag read"
            or name.startswith("fused_evolve") or name == "cgmres_many")


def _window_busy(prof, name):
    """The wall (ms) of the host span ``name`` in a profile, the device busy
    time (ms) of the kernels and copies that ran inside it, and their
    names."""
    import torch

    events = prof.events()
    win, = [e.time_range for e in events
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    inside = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not _is_span(e.name)
              and win.start <= e.time_range.start < win.end]
    busy = sum(e.time_range.elapsed_us() for e in inside)
    return win.elapsed_us() / 1e3, busy / 1e3, {e.name for e in inside}


def _profiled(fn):
    """One call of ``fn`` under ``torch.profiler``: its wall (s), the device
    busy time (ms, the kernels' and copies' own time), the idle share of the
    wall, and the names of the device's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not _is_span(e.key)]
    busy_us = sum(e.self_device_time_total for e in events)
    return (wall, busy_us / 1e3, 1.0 - busy_us / 1e6 / wall,
            {e.key for e in events}, prof)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def phase_graph_core(s, record):
    """The device core at full width: swe M=512, unpreconditioned, k=60,
    tol=1e-9, through ``cgmres(loop="while")`` with ``cgs2`` and with
    ``cgs2_fused``, held to ``reference/slice1.json`` and to the host loop
    on the card; the eager device core on the card against the replays;
    walls, ``time_capture``, device busy and idle share of both loops, and
    the kernels inside the replays (counters and profiler).  Returns the
    launches of one graph solve per ortho."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.solvers.graphs import (
        GraphRunner,
    )

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    rec = record["swe_M512"]["cgmres"]
    cons = s.constraints()
    kw = dict(k=SWE_K, tol=SWE_TOL, constraints=cons)
    paths = {}
    for ortho in ("cgs2", "cgs2_fused"):
        tag = f"[swe_M{SWE_M}_graph_core {ortho}]"

        def host():
            return cg.cgmres(s.A, s.b, ortho=ortho, **kw)

        def graphs(timing=False):
            return cg.cgmres(s.A, s.b, ortho=ortho, loop="while",
                             timing=timing, **kw)

        def timed(fn):
            walls = []
            for _ in range(GRAPH_SOLVES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            return out, walls

        host()
        (xh, ih), host_walls = timed(host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xg, ig = graphs(timing=True)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t = ig["timings"]
        core = next(iter(cg._CORES.values()))
        _, graph_walls = timed(graphs)
        _reset_launches()
        x2, i2 = graphs()
        torch.cuda.synchronize()
        launches = _read_launches()
        eager = cg.DeviceCore(s.A, None, SWE_K, cons, like=s.b, tol=SWE_TOL,
                              ortho=ortho, x0_zero=True,
                              runner=GraphRunner(DEVICE, capture=False))
        eager.load(s.b, None, cons)
        eager.solve()
        xe = eager.result().x
        del eager
        hp = _profiled(host)
        gp = _profiled(graphs)
        res = float(torch.linalg.norm(s.b - s.A @ xg))
        med = sorted(graph_walls)[GRAPH_SOLVES // 2]
        hmed = sorted(host_walls)[GRAPH_SOLVES // 2]
        print(f"{tag} graphs: steps {ig['steps']} (record {rec['steps']}), "
              f"constrained {ig['constrained_steps']} (record "
              f"{rec['constrained_steps']}), safety {ig['safety']}, KKT "
              f"deviation {ig['deviation']:.3e}, kkt iterations "
              f"{ig['kkt_iters']}, true residual {res:.4e}; host loop: steps "
              f"{ih['steps']}, constrained {ih['constrained_steps']}")
        print(f"{tag} wall, median of {GRAPH_SOLVES}: host loop "
              f"{1e3 * hmed:.3f} ms ({', '.join(f'{1e3 * w:.3f}' for w in host_walls)}), "
              f"graphs {1e3 * med:.3f} ms ({', '.join(f'{1e3 * w:.3f}' for w in graph_walls)}); "
              f"first graph solve {1e3 * first:.1f} ms, of it capture "
              f"{1e3 * t['time_capture']:.1f} ms ({core.runner.captures} "
              f"graphs); phase 1 {1e3 * t['iter_time_unconstrained']:.3f} "
              f"ms/iteration over {t['phase1_steps_measured']}, catch-up "
              f"{1e3 * t['constraint_building']:.3f} ms, endgame "
              f"{1e3 * t['iter_time_constrained']:.3f} ms/constrained step")
        print(f"{tag} profiled: host loop wall {1e3 * hp[0]:.3f} ms, busy "
              f"{hp[1]:.3f} ms, idle {hp[2]:.3f}; graphs wall "
              f"{1e3 * gp[0]:.3f} ms, busy {gp[1]:.3f} ms, idle {gp[2]:.3f}; "
              f"busy over the unprofiled median wall: host loop "
              f"{1.0 - hp[1] / 1e3 / hmed:.3f} idle, graphs "
              f"{1.0 - gp[1] / 1e3 / med:.3f} idle")
        print(f"{tag} x against the host loop {_rel(xg, xh):.3e}, eager "
              f"device core against the replays {_rel(xg, xe):.3e} (bit-equal "
              f"{bool(torch.equal(xg, xe))}), a second replayed solve "
              f"bit-equal {bool(torch.equal(xg, x2))}")
        print(f"{tag} launches over one graph solve: {launches}; per replay "
              f"by graph: {core.runner.launches()}")
        kernels = sorted(name for name in gp[3]
                         if "dia_spmv" in name or "fused_update_matvec" in name)
        print(f"{tag} kernels the profiler saw in the replays: {kernels}")
        for info in (ig, i2):
            check(info["safety"] is True, f"{tag} safety {info['safety']}")
            for key in ("steps", "constrained_steps"):
                check(_within_one(info, rec, key),
                      f"{tag} {key} {info[key]} vs record {rec[key]}")
            check(info["deviation"] <= DEVIATION_MAX,
                  f"{tag} KKT deviation {info['deviation']:.3e}")
        check(math.isfinite(res) and res < SWE_TOL,
              f"{tag} true residual {res:.3e}")
        check(_rel(xg, xh) <= 1e-10, f"{tag} x {_rel(xg, xh):.3e} from the "
                                     f"host loop")
        check(_rel(xg, xe) <= 1e-13, f"{tag} replays {_rel(xg, xe):.3e} from "
                                     f"the eager device core")
        _check_design(tag, launches, "dia_spmv")
        check(any("dia_spmv" in name for name in kernels),
              f"{tag} the profiler saw no DIA kernel in the replays")
        if ortho == "cgs2_fused":
            check(launches["fused_update_matvec"] == i2["steps"],
                  f"{tag} kernel #5 launched {launches['fused_update_matvec']} "
                  f"times over {i2['steps']} Arnoldi steps")
            check(any("fused_update_matvec" in name for name in kernels),
                  f"{tag} the profiler saw no kernel #5 in the replays")
        paths[ortho] = launches
    cg.clear_core_cache()
    return paths


def phase_fused_evolve(record4, record8, host_walls):
    """The swe M=512 Evolve row (skew-normal Chebyshev, ``cgs2_fused``)
    through ``fused_evolve``: from zero each step against
    ``swe_M512_snc_evolve``, and warm-started (the default) against
    ``swe_M512_snc_fused``; step walls beside the host loop's
    (``phase_snc_evolve``), ``time_capture`` and the idle share of one
    profiled evolution.  Returns the launches of each."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import swe

    params = dict(M=SWE_M, N=EVOLVE_N, T=EVOLVE_T)
    pre = default_pre_builder("swe")(swe.linforms(device=DEVICE, **params))

    def run(warm):
        return fused_evolve("swe", k=SNC_K, tol=SNC_TOL, pre=pre,
                            warm_start=warm, ortho="cgs2_fused",
                            device=DEVICE, **params)

    paths = {}
    for warm, name, rec in (
            (False, f"swe_M{SWE_M}_snc_evolve", record4[f"swe_M{SWE_M}_snc_evolve"]),
            (True, f"swe_M{SWE_M}_snc_fused", record8[f"swe_M{SWE_M}_snc_fused"])):
        tag = f"[fused_evolve {name}]"
        _reset_launches()
        out = run(warm)
        torch.cuda.synchronize()
        launches = _read_launches()
        t = out["timings"]
        e0 = abs(rec["series"]["energy"][0])
        print(f"{tag} warm_start={warm}: steps {list(map(int, out['steps']))} "
              f"(record {rec['steps']}), safety "
              f"{list(map(int, out['safety']))}; drift dm "
              f"{[float(d) for d in out['dm']]}, de/|e0| "
              f"{[float(d / e0) for d in out['de']]}")
        print(f"{tag} step walls {', '.join(f'{1e3 * w:.3f}' for w in t['step_wall'])} "
              f"ms, of them capture "
              f"{', '.join(f'{1e3 * c:.3f}' for c in t['step_capture'])} ms "
              f"(time_capture {t['time_capture']:.3f} s); host-loop evolve "
              f"(phase_snc_evolve) {', '.join(f'{1e3 * w:.3f}' for w in host_walls)} ms")
        print(f"{tag} launches over the evolution: {launches}; per replay by "
              f"graph: {t['launches_per_replay']}")
        check(len(out["steps"]) == EVOLVE_N, f"{tag} ran {len(out['steps'])} steps")
        for got, want in zip(out["steps"], rec["steps"]):
            check(abs(int(got) - want) <= 1,
                  f"{tag} steps {out['steps']} vs record {rec['steps']}")
        check(all(int(sf) == 1 for sf in out["safety"]), f"{tag} safety "
                                                         f"{out['safety']}")
        check(all(d < 1e-9 for d in out["dm"]), f"{tag} mass drift {out['dm']}")
        check(all(d / e0 < 1e-13 for d in out["de"]),
              f"{tag} energy drift {out['de']}")
        check(bool(torch.isfinite(out["sol"]).all()), f"{tag} solution not finite")
        # the counters count replays only (the core's and the evolution's
        # warm-ups put theirs back): each graph's launches times its replays
        replayed = {nm: t["launches"].get(nm, 0) for nm in launches}
        check(launches == replayed, f"{tag} launches {launches} are not the "
                                    f"replays' {replayed}")
        check(launches["dia_spmv"] > 0 and launches["fused_update_matvec"] > 0,
              f"{tag} did not go through kernels #1 and #5: {launches}")
        _check_design(tag, launches, "dia_spmv")
        paths[f"swe_M{SWE_M}_snc_fused_evolve" + ("" if warm else "_cold")] = \
            launches
    box = {}
    prof = _profiled(lambda: box.setdefault("out", run(True)))[4]
    wall, busy, names = _window_busy(prof, "fused_evolve steps")
    cap = 1e3 * box["out"]["timings"]["time_capture"]
    kernels = sorted(nm for nm in names
                     if "dia_spmv" in nm or "fused_update_matvec" in nm)
    print(f"[fused_evolve profiled] warm evolution, its {EVOLVE_N} steps and "
          f"the fetch: wall {wall:.3f} ms, of it capture {cap:.3f} ms; device "
          f"busy {busy:.3f} ms; idle share of the wall less capture "
          f"{1.0 - busy / (wall - cap):.3f}; kernels #1 and #5 in the "
          f"replays: {kernels}")
    for want in ("dia_spmv", "fused_update_matvec"):
        check(any(want in nm for nm in kernels),
              f"[fused_evolve profiled] the profiler saw no {want} kernel in "
              f"the replays")
    return paths


LKDVRK_ROWS = ("lkdvrk_M400_deg3_s2", "lkdvrk_M400_deg4_s3",
               "lkdvrk_M400_deg5_s4")
LKDVRK_EVOLVE = "lkdvrk_M400_deg3_s2_evolve"


def _dia_designs(*ops):
    """The DIA kernel's designs on a path whose DIA operators are ``ops``:
    the one every plan picks, first, or None where the plans disagree."""
    picks = {op.live().pays for op in ops}
    if len(picks) > 1:
        return None
    return {**DESIGNS, "dia_spmv": ("live", "dense") if picks.pop()
            else ("dense", "live")}


def _check_dia_path(tag, launches, ops):
    """Kernel #1 ran on the path, each launch in the design the plans of its
    DIA operators ``ops`` pick where they agree."""
    designs = _dia_designs(*ops)
    if designs is None:
        print(f"{tag} dia_spmv: {launches['dia_spmv']} launches, "
              f"{launches['dia_spmv_live']} live and "
              f"{launches['dia_spmv_dense']} dense (the operators' plans "
              f"pick both)")
        check(launches["dia_spmv"] > 0, f"{tag} kernel #1 never launched")
    else:
        _check_design(tag, launches, "dia_spmv", designs=designs)


def phase_lkdvrk_kernel(s):
    """Kernel #1 on the lkdvRK stage operator of the grid's (3, 2) row at
    M=400 (42 wrapped diagonals, n = 9,600) against its plain twin in f64
    and f32, with its live share and the design ``A @ x`` picks; then its
    times with L2 flushed beside the bound on the stored non-zeros and
    cuSPARSE CSR.  Returns the largest f64 error and the timing fields."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    A = s.A
    check(type(A).__name__ == "DIA" and len(A.offsets) == 42 and A.wrap,
          f"lkdvRK (3,2) A is {type(A).__name__}, not a wrapped DIA of 42 "
          f"diagonals")
    err = _check_dia("lkdvrk_M400_deg3_s2_A", A, gen)
    x = torch.randn(A.shape[0], generator=gen, device=DEVICE,
                    dtype=torch.float64)
    return err, _time_dia(A, s.A_csr, x, "lkdvRK (3,2) M=400")


def _composite_times(tag, s, pre):
    """Device times of one apply of the RAS + Neumann composite, of its RAS
    inner and of its ``A @ z``, back to back (the inverses exceed L2), and
    the composite's byte bound: the inverses read degree + 1 times."""
    import torch

    v = torch.randn(s.b.shape[0], device=DEVICE, dtype=torch.float64,
                    generator=torch.Generator(device=DEVICE).manual_seed(3))
    nb, bs = pre.inner.idx.shape
    out = {"ms": _time_ms(lambda: pre(v), reps=20),
           "ras_ms": _time_ms(lambda: pre.inner(v), reps=20),
           "spmv_ms": _time_ms(lambda: s.A @ v, reps=50),
           "inverse_bytes": nb * bs * bs * 8}
    out["bound_ms"] = 1e3 * (pre.degree + 1) * out["inverse_bytes"] / HBM_BYTES_PER_S
    out["ras_bound_ms"] = 1e3 * out["inverse_bytes"] / HBM_BYTES_PER_S
    print(f"{tag} composite apply {out['ms']:.4f} ms against its bound "
          f"{out['bound_ms']:.4f} ms ({pre.degree + 1} reads of "
          f"{out['inverse_bytes'] / 1e9:.3f} GB of inverses, "
          f"{out['bound_ms'] / out['ms']:.1%}); RAS apply {out['ras_ms']:.4f} "
          f"ms (bound {out['ras_bound_ms']:.4f} ms, "
          f"{out['ras_bound_ms'] / out['ras_ms']:.1%}); A @ z "
          f"({type(s.A).__name__}) {out['spmv_ms']:.4f} ms")
    return out


def phase_lkdvrk_rows(record):
    """The seventh slice's main path: each row of the reference's
    error-sweep grid at M=400 through ``time_cgmres`` with the default
    lkdvRK pre-builder (RAS over 5 blocks, Neumann degree 3), held to
    ``reference/slice7.json``; the composite's device time per apply; and
    the (3, 2) row once more with the fused orthogonalisation.  Returns,
    per row, its numbers and the launches over it."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
        time_cgmres,
    )

    rows = {}
    for name in LKDVRK_ROWS:
        rec = record[name]
        cfg = rec["config"]
        tag = f"[{name}]"
        seen = {}

        def pre_builder(system):  # the default, keeping what it was given
            seen["system"] = system
            seen["pre"] = default_pre_builder("lkdvrk")(system)
            return seen["pre"]

        _reset_launches()
        t0 = time.perf_counter()
        out = time_cgmres("lkdvrk", k=cfg["k"], tol=cfg["tol"],
                          pre_builder=pre_builder, device=DEVICE,
                          **cfg["params"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        s, pre = seen["system"], seen["pre"]
        fmt = ({"format": "DIA", "width": len(s.A.offsets)}
               if type(s.A).__name__ == "DIA"
               else {"format": "ELL", "width": s.A.row_width})
        blocks = list(pre.inner.idx.shape)
        devs = max(out["conservation"][f"cgmres_{nm}"]
                   for nm in out["invariant_names"])
        ratio = out["runtime"] / out["time_gmres"]
        print(f"{tag} n={s.b.shape[0]}, A {fmt['format']} width "
              f"{fmt['width']} (record {rec['format']} {rec['width']}), RAS "
              f"blocks {blocks} (record {rec['ras_blocks']}), "
              f"time_cgmres wall {wall:.3f} s")
        print(f"{tag} time_pre {out['time_pre']:.4f} s (first build "
              f"{out['time_pre_first']:.4f} s), gmres: steps "
              f"{out['gmres_steps']} (record {rec['gmres']['steps']}), wall "
              f"{out['time_gmres']:.4f} s; cgmres: steps {out['steps']} "
              f"(record {rec['cgmres']['steps']}), constrained "
              f"{out['constrained_steps']} (record "
              f"{rec['cgmres']['constrained_steps']}), safety {out['safety']}"
              f", runtime {out['runtime']:.4f} s, CGMRES/GMRES {ratio:.3f}; "
              f"largest invariant deviation {devs:.3e}")
        print(f"{tag} launches over the row: {launches}")
        times = _composite_times(tag, s, pre)
        check(fmt == {"format": rec["format"], "width": rec["width"]},
              f"{tag} A is {fmt}, the record {rec['format']} {rec['width']}")
        check(blocks == rec["ras_blocks"],
              f"{tag} RAS blocks {blocks} vs record {rec['ras_blocks']}")
        check(out["safety"] is rec["cgmres"]["safety"] is True,
              f"{tag} safety {out['safety']}")
        _check_at_most(tag + " cgmres", out, rec["cgmres"],
                       ("steps", "constrained_steps"))
        check(abs(out["gmres_steps"] - rec["gmres"]["steps"]) <= 1,
              f"{tag} gmres steps {out['gmres_steps']} vs record "
              f"{rec['gmres']['steps']}")
        check(devs <= DEVIATION_MAX, f"{tag} CGMRES deviation {devs:.3e}")
        # the row's DIA products: A where it is a DIA, and the mass matrix
        # inside the stage-mapped constraints
        _check_dia_path(tag, launches, [op for op in (s.A, s.Mmat)
                                        if type(op).__name__ == "DIA"])
        rows[name] = {"launches": launches, "time_pre": out["time_pre"],
                      "time_pre_first": out["time_pre_first"],
                      "runtime": out["runtime"],
                      "time_gmres": out["time_gmres"],
                      "cgmres_over_gmres": ratio, "wall": wall,
                      "composite": times, **fmt, "ras_blocks": blocks}
        if name == LKDVRK_ROWS[0]:
            rows[name]["fused"] = _lkdvrk_fused(tag, s, pre, rec)
        del seen, s, pre
        torch.cuda.empty_cache()
    return rows


def _lkdvrk_fused(tag, s, pre, rec):
    """GMRES and CGMRES on a stage system with the fused orthogonalisation:
    kernel #5 once per Arnoldi step.  Returns the launches."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers

    cfg = rec["config"]
    kw = dict(k=cfg["k"], tol=cfg["tol"], pre=pre, ortho="cgs2_fused")
    _reset_launches()
    xg, ig = wrappers.gmres_wrapper(s, **kw)
    xc, ic = wrappers.cgmres_wrapper(s, **kw)
    torch.cuda.synchronize()
    launches = _read_launches()
    print(f"{tag} cgs2_fused: gmres steps {ig['steps']}, cgmres steps "
          f"{ic['steps']} constrained {ic['constrained_steps']} safety "
          f"{ic['safety']} deviation {ic['deviation']:.3e}; launches "
          f"{launches}")
    check(ic["safety"] is True and ic["deviation"] <= DEVIATION_MAX,
          f"{tag} cgs2_fused CGMRES safety {ic['safety']}, deviation "
          f"{ic['deviation']:.3e}")
    _check_at_most(tag + " cgs2_fused cgmres", ic, rec["cgmres"],
                   ("steps", "constrained_steps"))
    check(abs(ig["steps"] - rec["gmres"]["steps"]) <= 1,
          f"{tag} cgs2_fused gmres steps {ig['steps']}")
    check(launches["fused_update_matvec"] == ig["steps"] + ic["steps"],
          f"{tag} kernel #5 launched {launches['fused_update_matvec']} times "
          f"over {ig['steps'] + ic['steps']} Arnoldi steps")
    return launches


def phase_lkdvrk_evolve(record):
    """One evolution of the error sweep on the card:
    ``error_sweep.run_single("CGMRES", 3, 2, 1e-3, N=10, M=400)``, held to
    the record's steps and drifts, and its L2 error series to the same
    evolution by the port's plain twins on this machine's CPU.  Each CGMRES
    solve stops three steps in at tol=1e-3 and the next step's system is
    built from its iterate, so a series moves by about 1e-6 of itself under
    a 1e-15 change of each step's b (the JAX package's ``own_drift`` in the
    record), and by more under another host's libraries and thread count
    (PERF.md §6): the card is held to max(1e-6, 10× that drift) from the
    plain path on its own host, and its distance from the record is
    printed.
    Returns the launches and the wall of each step."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import (
        error_sweep,
        wrappers,
    )

    rec = record[LKDVRK_EVOLVE]
    cfg = rec["config"]
    (degree, tstages, tol), = cfg["grid"]
    run = rec["runs"][f"CGMRES_{degree}_{tstages}"]
    tag = f"[{LKDVRK_EVOLVE}]"
    solve, starts = wrappers.cgmres_wrapper, []
    args = dict(N=cfg["N"], M=cfg["M"], k=cfg["k"])
    tmpdir = ROOT / "build" / "chip_smoke"

    def timed(system, **kw):  # the start of each step's solve
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return solve(system, **kw)

    _reset_launches()
    wrappers.cgmres_wrapper = timed
    t0 = time.perf_counter()
    try:
        out = error_sweep.run_single("CGMRES", degree, tstages, tol,
                                     tmpdir=str(tmpdir / "card"),
                                     device=DEVICE, **args)
    finally:
        wrappers.cgmres_wrapper = solve
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = _read_launches()
    step_walls = [b - a for a, b in zip(starts, starts[1:] + [t_end])]
    t1 = time.perf_counter()
    host = error_sweep.run_single("CGMRES", degree, tstages, tol,
                                  tmpdir=str(tmpdir / "host"), device="cpu",
                                  **args)
    host_wall = time.perf_counter() - t1

    def rel(a, b):
        return max(abs(x - y) for x, y in zip(a, b)) / max(abs(y) for y in b)

    err, ref = [float(e) for e in out["err"]], run["err"]
    err_host = [float(e) for e in host["err"]]
    bar = max(1e-6, 10.0 * run["own_drift"])
    e0 = abs(out["energy"][0])
    print(f"{tag} wall {t_end - t0:.3f} s, of it assembly and the RAS build "
          f"{starts[0] - t0:.3f} s and {len(step_walls)} steps of "
          f"{', '.join(f'{1e3 * w:.3f}' for w in step_walls)} ms; steps "
          f"{out['steps']} (record {run['steps']}); the same on the host's "
          f"CPU {host_wall:.3f} s")
    print(f"{tag} err {err}; max|derr|/max|err|: card against the host's "
          f"plain path {rel(err, err_host):.3e} (bar {bar:.3e}: the record's "
          f"own drift {run['own_drift']:.3e}), card against the record "
          f"{rel(err, ref):.3e}, host against the record "
          f"{rel(err_host, ref):.3e}; dm {[float(d) for d in out['dm']]}; "
          f"de/|e0| {[float(d / e0) for d in out['de']]}")
    print(f"{tag} launches over the evolution: {launches}")
    check(len(err) == len(ref) == len(err_host)
          and rel(err, err_host) <= bar,
          f"{tag} error series off the host's plain path by "
          f"{rel(err, err_host):.3e} (bar {bar:.3e})")
    for got, want in zip(out["steps"], run["steps"]):
        check(abs(got - want) <= 1,
              f"{tag} steps {out['steps']} vs record {run['steps']}")
    check(all(d <= 1e-9 for d in out["dm"]), f"{tag} mass drift {out['dm']}")
    # the energy drift jumps by about 3e-12 |e0| at the second step, where
    # step_update re-derives the auxiliary fields, in the JAX package too:
    # held to the record's series within 1e-12 |e0| a step
    check(all(abs(d - r) <= 1e-12 * i * e0
              for i, (d, r) in enumerate(zip(out["de"], run["de"]))),
          f"{tag} energy drift {out['de']} vs record {run['de']}")
    check(launches["dia_spmv"] > 0, f"{tag} kernel #1 never launched")
    return launches, step_walls


def phase_general():
    """CGMRES on lkdv M=100, degree 3 (tests/test_cgmres_lkdv.py's hard
    system) with the energy written as a ``GeneralConstraint`` on the card:
    its Taylor models differentiate through the DIA kernel.  It must
    certify and match the quadratic path's deviations.  Returns the
    launches over the general solve."""
    import torch

    from structurepreservingiterativesolvers_torch.constraints import (
        GeneralConstraint,
    )
    from structurepreservingiterativesolvers_torch.models import lkdv
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    tag = "[lkdv hard general]"
    s = lkdv.linforms(M=100, degree=3, device=DEVICE)
    mass, mom, energy_q = s.constraints()

    def energy(x):
        u, _, w = torch.split(x, s.n0)
        return (0.5 * torch.dot(w, s.Mmat @ w) - 0.5 * torch.dot(u, s.Mmat @ u)
                - s.e0)

    kw = dict(k=50, tol=1e-6)
    xq, iq = cgmres(s.A, s.b, constraints=[mass, mom, energy_q], **kw)
    _reset_launches()
    t0 = time.perf_counter()
    xg, ig = cgmres(s.A, s.b, constraints=[
        mass, mom, GeneralConstraint(func=energy, name="energy")], **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    dq, dg = _deviations(s, xq), _deviations(s, xg)
    gap = max(abs(dg[k] - dq[k]) for k in dq)
    print(f"{tag} steps {ig['steps']} (quadratic {iq['steps']}), constrained "
          f"{ig['constrained_steps']}, safety {ig['safety']}, wall {wall:.3f}"
          f" s; deviations {dg}, quadratic path {dq}, largest gap "
          f"{gap:.3e}; launches {launches}")
    check(ig["safety"] is True, f"{tag} safety {ig['safety']}")
    check(max(abs(d) for d in dg.values()) <= DEVIATION_MAX,
          f"{tag} deviations {dg}")
    check(gap <= DEVIATION_MAX, f"{tag} deviations off the quadratic path "
                                f"by {gap:.3e}")
    check(launches["dia_spmv"] > 0, f"{tag} kernel #1 never launched")
    return launches


# the ninth slice: the batched DIA kernel against its plain twin (max|dY| /
# max|Y|; each column sums as kernel #1 does, within 1e-12 in f64), the
# widths it is held and timed at, and the batched rows of
# reference/slice9.json
SPMM_RTOL = {"float64": 1e-12, "float32": 1e-6}
SPMM_BATCHES = (1, 2, 3, 8, 41)
BATCH_ROWS = ("swe_M512_B8", "swe_M512_snc_B8")
# each item's residual trace against the record's up to the record's first
# open gate (the unconstrained steps, which the endgame's leveling-off near
# tol does not reach): within 1e-10 relative plus a floor of 1e-12 of the
# first residual, where a true residual's rounding lies (the port's traces on
# the H100 are 2e-16 to 3e-13 of it from the record's there); x's max-norm
# and sum within 1e-10 relative
TRACE_RTOL, TRACE_FLOOR, X_RTOL = 1e-10, 1e-12, 1e-10
# the gate's factor: cgmres_many's default, which the record's solves took
CONTOL = 10.0


def _reference_script():
    """``scripts/make_torch_reference.py`` as a module (no JAX is imported
    until one of its records is made): the batches' items are defined
    there once."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_reference", ROOT / "scripts" / "make_torch_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class SpmmShapes:
    """The batched kernel's launches on each path, as each was resolved (a
    graph's at its capture): ``by_path[path]`` holds (n, B, dtype, design)
    of each.  While a path runs (from ``path`` to ``checks``), the port's
    batched launch (``ops/sparse.py``'s ``launch_many``, which ``A @ X``
    reaches) is wrapped: the wrapper resolves the launch's plan, notes it
    and launches with it, so the design noted is the one that ran.
    ``checks`` puts the port's own launch back, for the kernel checks and
    timings and after the last path."""

    def __init__(self):
        from structurepreservingiterativesolvers_torch.ops import sparse as tsp

        self.by_path, self.running = {}, None
        self._sparse, self._launch = tsp, tsp.launch_many

    def _noted(self, rec, X, plan=None):
        from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

        if plan is None:
            plan = kd.spmm_plan(rec.n, X.shape[1], rec.dtype, rec.strip)
        self.by_path.setdefault(self.running, set()).add(
            (rec.n, X.shape[1], str(rec.dtype).split(".")[-1], plan.design))
        return self._launch(rec, X, plan)

    def path(self, name):
        """Note the batched launches from here on under path ``name``."""
        self.running = name
        self._sparse.launch_many = self._noted

    def checks(self):
        """Stop noting: the port's own batched launch from here on."""
        self.running = None
        self._sparse.launch_many = self._launch

    def widest(self, path, n):
        """The widest block of n rows that the batched kernel took on
        ``path``: the catch-up's jmax where the path's constraint matrix is
        a DIA of n rows."""
        widths = [B for m, B, _, _ in self.by_path.get(path, ()) if m == n]
        check(bool(widths), f"no batched launch of {n} rows on {path}: "
                            f"{sorted(self.by_path.get(path, ()))}")
        return max(widths)

    def report(self):
        """The shapes of every path that ran the batched kernel, checks and
        timings left out."""
        return {path: sorted(shapes) for path, shapes in self.by_path.items()}


def _field_view(n0, B, gen, dtype):
    """The catch-up's operand for a 3-field constraint (lkdv's and lkdvRK's
    mass matrix on one field): rows n0 .. 2 n0 of the (3 n0, B) view of B
    basis rows, at the stride 3 n0 from an element n0 in."""
    import torch

    Z = torch.randn(B, 3 * n0, generator=gen, device=DEVICE, dtype=dtype)
    return Z.T[n0:2 * n0]


def _check_spmm(label, A, gen, batches, dtypes=("float64", "float32"),
                operand=None):
    """The batched kernel on the DIA ``A`` against its plain twin for each
    block width in ``batches``, on the (n, B) view of a (B, n) block (read
    without a copy; ``operand(B, gen, dtype)`` gives another, as the
    catch-up reads it), on a contiguous (n, B) block (copied into that
    layout first) and on rows at an odd stride: ``A @ X`` in the design
    ``spmm_plan`` picks, each launch counted in the plan's counter and its
    design's, then both designs forced (tile, spread) on the
    operator's live plan and without it, all the same bits, a second launch
    too, and each column bit-equal to kernel #1's product of it (the same
    sums in the same order).  Returns the largest f64 absolute error and
    the designs the plan picked."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

    max_abs, picked = 0.0, set()
    n = A.shape[0]
    for tag in dtypes:
        dtype = getattr(torch, tag)
        Ad = A if A.dtype == dtype else A.astype(dtype)
        plan = Ad.live()
        for B in batches:
            X = (operand(B, gen, dtype) if operand else
                 torch.randn(B, n, generator=gen, device=DEVICE, dtype=dtype).T)
            odd = torch.randn(B, n + 1, generator=gen, device=DEVICE,
                              dtype=dtype)[:, 1:].T
            odd.copy_(X)
            pick = kd.spmm_plan(n, B, dtype, kd.spmm_strip(n, A.offsets, dtype))
            picked.add(pick.design)
            counter = getattr(kd, f"dia_spmm_{pick.design}_cuda")
            before = (kd.dia_spmm_cuda.launches, kd.dia_spmm_live_cuda.launches,
                      counter.launches)
            Y = Ad @ X
            torch.cuda.synchronize()
            check(kd.dia_spmm_cuda.launches == before[0] + 1
                  and kd.dia_spmm_live_cuda.launches == before[1] + plan.pays
                  and counter.launches == before[2] + 1,
                  f"SpMM {label} {tag} B={B}: the launch did not count in "
                  f"its plan's counter and its design's ({pick.design})")
            outs = {"contiguous X": Ad @ X.contiguous(), "odd stride": Ad @ odd,
                    "again": Ad @ X}
            for design in kd.DESIGNS:
                force = getattr(kd, f"dia_spmm_{design}_cuda")
                outs[f"{design} live"] = force(Ad.data, Ad.offsets, Ad.wrap,
                                               X, plan)
                outs[f"{design} dense"] = force(Ad.data, Ad.offsets, Ad.wrap,
                                                odd)
            cols = torch.stack([Ad @ X[:, b].contiguous() for b in range(B)], 1)
            torch.cuda.synchronize()
            abs_err, rel = _rel_err(Y, kd.dia_spmm_torch(Ad.data, Ad.offsets,
                                                         Ad.wrap, X))
            differ = [k for k, v in outs.items() if not torch.equal(v, Y)]
            print(f"[spmm] {label} n={n} ndiag={len(A.offsets)} wrap={A.wrap} "
                  f"{tag} B={B}: max|dY|/max|Y| = {rel:.3e} (bound "
                  f"{SPMM_RTOL[tag]:.0e}), {'live' if plan.pays else 'dense'} "
                  f"plan, {pick.design} design (tile {pick.tile}, split "
                  f"{pick.split}, strip {pick.strip}); every design, layout "
                  f"and repeat bit-equal: {not differ} {differ}; columns "
                  f"equal kernel #1's {torch.equal(Y, cols)} (max|d| "
                  f"{float((Y - cols).abs().max()):.3e})")
            check(math.isfinite(rel) and rel <= SPMM_RTOL[tag],
                  f"SpMM kernel disagrees with plain on {label} {tag} B={B}: "
                  f"{rel:.3e}")
            check(not differ, f"SpMM {label} {tag} B={B}: {differ} differ")
            check(torch.equal(Y, cols),
                  f"SpMM {label} {tag} B={B}: columns differ from kernel #1")
            if tag == "float64":
                max_abs = max(max_abs, abs_err)
    return max_abs, picked


def _dia_csr(A):
    """A DIA as a scipy CSR matrix (the library yardstick's operand)."""
    import numpy as np
    import scipy.sparse as sp

    n = A.shape[0]
    data = A.data.double().cpu().numpy()
    rows, cols, vals = [], [], []
    for d, off in enumerate(A.offsets):
        r = np.arange(n)
        c = r + off
        keep = np.ones(n, bool) if A.wrap else (c >= 0) & (c < n)
        rows.append(r[keep])
        cols.append(c[keep] % n)
        vals.append(data[d][keep])
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))), (n, n))


def _time_spmm(A, B, label, gen, A_csr=None, X=None):
    """The batched kernel on an (n, B) view of a (B, n) block (or on ``X``,
    as its path reads it), with L2 flushed: ``A @ X`` in the design its plan
    picks and every design forced, beside B launches of kernel #1 on its
    columns (L2 flushed before the first), cuSPARSE SpMM (``torch.sparse.mm``
    of the CSR matrix with a contiguous (n, B) block), the plain twin, and
    the bound: the stored non-zeros read once, B vectors read and B
    written."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

    n = A.shape[0]
    if X is None:
        X = torch.randn(B, n, generator=gen, device=DEVICE,
                        dtype=torch.float64).T
    Xc = X.contiguous()
    cols = [X[:, b].contiguous() for b in range(B)]
    Acsr = _csr(A_csr if A_csr is not None else _dia_csr(A))
    check(_rel_err(A @ X, Acsr @ Xc)[1] <= SPMM_RTOL["float64"],
          f"SpMM {label} B={B}: the kernel and cuSPARSE differ")
    rec = A._launch
    plan = kd.spmm_plan(n, B, torch.float64, rec.strip)
    nnz = int(torch.count_nonzero(A.data))
    out = {"B": B, "plan": "live" if A.live().pays else "dense",
           "design": plan.design, "tile": plan.tile, "split": plan.split,
           "strips": n // plan.strip,
           "ms": _time_cold_ms(lambda: A @ X),
           "designs_ms": {design: _time_cold_ms(
               lambda: kd.launch_many(rec, X, kd.spmm_design(
                   design, n, B, torch.float64, rec.strip)))
               for design in kd.DESIGNS},
           "spmv_launches_ms": _time_cold_ms(lambda: [A @ c for c in cols]),
           "library_ms": _time_cold_ms(lambda: torch.sparse.mm(Acsr, Xc)),
           "plain_ms": _time_cold_ms(lambda: kd.dia_spmm_torch(
               A.data, A.offsets, A.wrap, X), reps=10)}
    out["bound_ms"], out["bound_by"] = _bound_ms((nnz + 2 * B * n) * 8,
                                                 2 * nnz * B)
    print(f"[spmm] {label} B={B} (n={n}, {nnz / n:.2f} non-zeros a row, f64, "
          f"L2 flushed): A @ X ({out['plan']} plan, {plan.design} design, "
          f"tile {plan.tile}, split {plan.split}, {out['strips']} strips) "
          f"{out['ms']:.4f} ms; by design " + ", ".join(
              f"{d} {t:.4f}" for d, t in out["designs_ms"].items())
          + f" ms; {B} launches of kernel #1 {out['spmv_launches_ms']:.4f} ms;"
          f" cuSPARSE SpMM {out['library_ms']:.4f} ms; plain "
          f"{out['plain_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}; A @ X at {out['bound_ms'] / out['ms']:.1%} "
          f"of it)")
    return out


def _why_spmm(A, B, label, gen):
    """What holds the batched kernel back on the DIA ``A`` at B vectors,
    from three yardsticks timed beside ``A @ X`` (L2 flushed): a device
    copy of the (B, n) block (the vectors' bytes alone, read once and
    written once, at the rate the card reaches for them); the product as
    launches of one tile each (each reads the coefficients again); and the
    same kernel on the same coefficients and live plan with the offsets
    folded near (consecutive, so that every x a row reads lies in the
    lines its first diagonal brought into L1), in the operator's strips:
    the same loads and multiply-adds without the far columns' reads from
    L2 or memory."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

    n = A.shape[0]
    X = torch.randn(B, n, generator=gen, device=DEVICE, dtype=torch.float64).T
    Y = A @ X
    rec = A._launch
    plan = kd.spmm_plan(n, B, torch.float64, rec.strip)
    tile = kd.TILES["tile"][-1]
    k = len(A.offsets)
    near = tuple(range(-(k // 2), k - k // 2))
    rec_near = kd.dia_launch(A.data, near, A.wrap, X[:, 0].contiguous(),
                             A.live() if A.live().pays else None)
    copy = torch.empty(B, n, dtype=torch.float64, device=DEVICE)
    check(torch.equal(torch.cat([kd.launch_many(rec, X[:, b:b + tile])
                                 for b in range(0, B, tile)], 1), Y),
          f"SpMM {label} B={B}: its tiles as launches differ")
    out = {"ms": _time_cold_ms(lambda: A @ X),
           "copy_ms": _time_cold_ms(lambda: copy.copy_(X.T)),
           "tile_launches_ms": _time_cold_ms(
               lambda: [kd.launch_many(rec, X[:, b:b + tile])
                        for b in range(0, B, tile)]),
           "near_offsets_ms": _time_cold_ms(
               lambda: kd.launch_many(rec_near, X, plan))}
    out["copy_bound_ms"] = _bound_ms(2 * B * n * 8, 0)[0]
    print(f"[spmm] {label} B={B}, what holds it back (L2 flushed): A @ X "
          f"{out['ms']:.4f} ms ({plan.design}, tile {plan.tile}, split "
          f"{plan.split}); a copy of its vectors {out['copy_ms']:.4f} ms "
          f"(bound {out['copy_bound_ms']:.4f}); its {-(-B // tile)} tiles "
          f"as launches {out['tile_launches_ms']:.4f} ms; offsets folded "
          f"near {out['near_offsets_ms']:.4f} ms")
    return out


def _trace_gap(res, rec_res, gate_at):
    """The largest |res[j] - rec_res[j]| as a share of the trace bar, over
    the steps j before the record's gate opens (its first residual at or
    below ``gate_at``), and the number of those steps."""
    j1 = next((j for j, r in enumerate(rec_res) if r <= gate_at),
              len(rec_res))
    share = max((abs(float(res[j]) - r)
                 / (TRACE_RTOL * r + TRACE_FLOOR * rec_res[0])
                 for j, r in enumerate(rec_res[:j1])), default=0.0)
    return share, j1


def _certifies(rec, i, tol):
    """Item i of a batched record certifies: latch 1, KKT deviation within
    the bar and true residual below tol."""
    return (rec["safety"][i] == 1 and rec["deviation"][i] <= DEVIATION_MAX
            and rec["true_residual"][i] < tol)


def phase_batched(record, shapes):
    """The ninth slice at full width: the batched kernel on swe M=512's A
    at every width of ``SPMM_BATCHES`` (checked and timed), then both rows
    of ``BATCH_ROWS`` through ``cgmres_many`` (B = 8, each step a CUDA
    graph), held to ``reference/slice9.json`` and to each item's own
    ``cgmres(loop="while")`` on the card; the median wall of 5 batched
    solves beside the 8 single solves, ``time_capture``, device busy and
    idle share under the profiler, and the batched kernel inside the
    replays (the counters against each graph's launches times its replays,
    and the profiler's kernel names inside the solve's span).  Returns the
    largest f64 error, the times by width, and per row its launches."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.kernels import (
        launch_counters,
    )
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.models import swe

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    ref = _reference_script()
    s = swe.linforms(M=SWE_M, device=DEVICE)
    A = s.A
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    shapes.checks()
    err, _ = _check_spmm(f"swe M={SWE_M} A", A, gen, SPMM_BATCHES)
    zero_filled = type(A)(A.data, A.offsets, A.shape, False)
    err = max(err, _check_spmm(f"swe M={SWE_M} A zero-filled", zero_filled,
                               gen, (1, 8), ("float64",))[0])
    times = {B: _time_spmm(A, B, f"swe M={SWE_M} A", gen, s.A_csr)
             for B in SPMM_BATCHES}
    for B in (8, SPMM_BATCHES[-1]):
        times[B]["why"] = _why_spmm(A, B, f"swe M={SWE_M} A", gen)
    pre_snc = default_pre_builder("swe")(s)
    rows = {}
    for name in BATCH_ROWS:
        shapes.path(name)
        tag = f"[{name}]"
        rec = record[name]
        _, _, B, k, tol, pre_spec, _ = ref.BATCHED[name]
        pre = pre_snc if pre_spec == "snc" else None
        states = torch.as_tensor(ref.batch_states(name, s.z0.cpu().numpy()),
                                 device=DEVICE)
        items = [s.step_update(z) for z in states]
        Bs = torch.stack([t.b for t in items])
        cons = [t.constraints() for t in items]
        own = [float(c.c) for c_list in cons for c in c_list]
        theirs = [tc for targets in rec["targets"] for tc in targets]
        print(f"{tag} the port's step_update puts the targets "
              f"{max(abs(a - b) for a, b in zip(own, theirs)):.3e} at most "
              f"from the record's (the JAX package's sums)")

        def many():
            return cgmres_many(A, Bs, cons, k=k, tol=tol, contol=CONTOL,
                               pre=pre)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, info = many()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        core = next(iter(cg._CORES.values()))
        runner = core.runner
        capture = runner.time_capture
        walls = []
        for _ in range(GRAPH_SOLVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            many()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # the launches of one solve: the counters against each graph's
        # launches times its replays in that solve
        names = {id(fn): nm for nm, fn in launch_counters().items()}
        replayed0 = dict(runner.replayed)
        _reset_launches()
        X2, info2 = many()
        torch.cuda.synchronize()
        launches = _read_launches()
        expected = {nm: 0 for nm in launches}
        for key, (_, counts) in runner.graphs.items():
            for counter, nl in counts:
                expected[names[id(counter)]] += nl * (
                    runner.replayed.get(key, 0) - replayed0.get(key, 0))
        prof = _profiled(many)
        span_wall, span_busy, span_names = _window_busy(prof[4], "cgmres_many")
        kernels = sorted(nm for nm in span_names if "dia_sp" in nm)
        med = sorted(walls)[GRAPH_SOLVES // 2]
        per_graph = runner.launches()
        # each item's own single solve on the card (one core, its graphs
        # captured by the first item's solve and replayed by the others)
        singles, single_walls = [], []
        for t, c in zip(items, cons):
            cg.cgmres(A, t.b, k=k, tol=tol, pre=pre, constraints=c,
                      loop="while")
        for t, c in zip(items, cons):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            singles.append(cg.cgmres(A, t.b, k=k, tol=tol, pre=pre,
                                     constraints=c, loop="while"))
            torch.cuda.synchronize()
            single_walls.append(time.perf_counter() - t0)
        cg.clear_core_cache()
        true_res = [float(torch.linalg.norm(t.A @ x - t.b))
                    for t, x in zip(items, X)]
        x_rel = [_rel(X[i], xs) for i, (xs, _) in enumerate(singles)]
        print(f"{tag} B={B}, k={k}, tol={tol:g}: steps "
              f"{list(map(int, info['steps']))} (record {rec['steps']}; single "
              f"solves {[i1['steps'] for _, i1 in singles]}), safety "
              f"{list(map(int, info['safety']))} (record {rec['safety']}), KKT "
              f"deviation {['%.2e' % d for d in info['deviation']]} (record "
              f"{['%.2e' % d for d in rec['deviation']]}), true residual "
              f"{['%.2e' % r for r in true_res]} (record "
              f"{['%.2e' % r for r in rec['true_residual']]})")
        print(f"{tag} x against each item's single device-core solve: "
              f"{['%.2e' % r for r in x_rel]}; a second batched solve "
              f"bit-equal {bool(torch.equal(X, X2))}")
        print(f"{tag} wall, median of {GRAPH_SOLVES} batched solves "
              f"{1e3 * med:.3f} ms ({', '.join(f'{1e3 * w:.3f}' for w in walls)}); "
              f"first (capturing) {1e3 * first:.1f} ms, time_capture "
              f"{1e3 * capture:.1f} ms ({runner.captures} graphs); the {B} "
              f"single graph-core solves {1e3 * sum(single_walls):.3f} ms in "
              f"all ({', '.join(f'{1e3 * w:.3f}' for w in single_walls)})")
        print(f"{tag} profiled batched solve: wall {1e3 * prof[0]:.3f} ms, "
              f"busy {prof[1]:.3f} ms, idle {prof[2]:.3f}; inside its span "
              f"{span_wall:.3f} ms, busy {span_busy:.3f} ms; busy over the "
              f"unprofiled median wall {1.0 - prof[1] / 1e3 / med:.3f} idle")
        print(f"{tag} launches over one batched solve: {launches}; each "
              f"graph's launches times its replays: {expected}; per replay "
              f"by graph: {per_graph}; DIA kernels the profiler saw in the "
              f"solve's span: {kernels}")
        spread = rec["spread"]
        held = spread["numpy_targets"]["steps"]
        print(f"{tag} the JAX package's steps: record {rec['steps']}, "
              + ", ".join(f"{label} {run['steps']}"
                          for label, run in spread.items())
              + f"; the port's are held to numpy_targets {held}")
        traces = [_trace_gap(info["res"][i], rec["res"][i], CONTOL * tol)
                  for i in range(B)]
        x_max = X.abs().amax(dim=1).tolist()
        x_sum = X.sum(dim=1).tolist()
        x_gap = [max(abs(a - b) / abs(b) for a, b in pair)
                 for pair in zip(zip(x_max, rec["x_max"]),
                                 zip(x_sum, rec["x_sum"]))]
        print(f"{tag} residual traces against the record's before its gate "
              f"opens (steps {[j1 for _, j1 in traces]}): the largest gap as "
              f"a share of the bar {['%.2e' % g for g, _ in traces]}; x's "
              f"max-norm and sum from the record's, relative "
              f"{['%.2e' % g for g in x_gap]}")
        for i, (xs, i1) in enumerate(singles):
            check(int(info["safety"][i]) == rec["safety"][i] == 1,
                  f"{tag} item {i}: safety {info['safety'][i]}, record "
                  f"{rec['safety'][i]}")
            check(int(info["steps"][i]) == i1["steps"],
                  f"{tag} item {i}: {info['steps'][i]} steps, its single "
                  f"solve {i1['steps']}")
            check(x_rel[i] <= 1e-10, f"{tag} item {i}: x {x_rel[i]:.3e} from "
                                     f"its single solve")
            # the JAX package given the targets as the port sums them
            check(int(info["steps"][i]) == held[i],
                  f"{tag} item {i}: {info['steps'][i]} steps, the JAX "
                  f"package's with numpy-summed targets {held[i]}")
            check(traces[i][0] <= 1.0 and traces[i][1] > 0,
                  f"{tag} item {i}: residual trace off the record's by "
                  f"{traces[i][0]:.3e} of the bar")
            check(x_gap[i] <= X_RTOL, f"{tag} item {i}: x's max-norm or sum "
                                      f"{x_gap[i]:.3e} from the record's")
            if _certifies(rec, i, tol):
                check(info["deviation"][i] <= DEVIATION_MAX
                      and true_res[i] < tol,
                      f"{tag} item {i}: deviation {info['deviation'][i]:.3e}, "
                      f"true residual {true_res[i]:.3e}")
        check(torch.equal(X, X2), f"{tag} a second batched solve differs")
        check(launches == expected, f"{tag} launches {launches} are not the "
                                    f"replays' {expected}")
        check(launches["dia_spmm"] > 0 and launches["dia_spmv"] == 0,
              f"{tag} the batch's products did not all run the batched "
              f"kernel: {launches}")
        check(launches["dia_spmm_live"] == launches["dia_spmm"],
              f"{tag} the batched kernel ran other than its live design")
        want = kd.spmm_plan(SWE_N, B, torch.float64,
                            kd.spmm_strip(SWE_N, A.offsets, torch.float64))
        check(launches[f"dia_spmm_{want.design}"] == launches["dia_spmm"],
              f"{tag} the batched kernel ran other than the {want.design} "
              f"design its plan picks: {launches}")
        check(any("dia_spmm" in nm for nm in kernels),
              f"{tag} the profiler saw no batched kernel in the solve's span")
        rows[name] = {"launches": launches, "wall_ms": 1e3 * med,
                      "single_ms": 1e3 * sum(single_walls)}
    shapes.checks()
    del s, pre_snc
    return err, times, rows


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

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.models import (
        heat,
        lkdv,
        lkdvrk,
        swe,
    )

    records = {name: json.loads((PACKAGE / "reference" / name).read_text())
               for name in ("slice1.json", "slice2.json", "slice3.json",
                            "slice4.json", "slice7.json", "slice8.json",
                            "slice9.json")}
    t_start = time.perf_counter()
    phase_build()
    shapes = SpmmShapes()
    t0 = time.perf_counter()
    swe_sys = swe.linforms(M=SWE_M, device=DEVICE)
    print(f"[swe M={SWE_M}] assembly {time.perf_counter() - t0:.2f} s")
    dia_err, dia_swe = phase_kernel(swe_sys, lkdv.linforms(M=100, degree=3,
                                                           device=DEVICE))
    torch.cuda.synchronize()
    poly_err = phase_poly_kernels({f"swe M={SWE_M}": swe_sys.A})
    torch.cuda.synchronize()
    shapes.path("lkdv")
    lk_sys, lkdv_launches = phase_lkdv(records["slice1.json"])
    torch.cuda.synchronize()
    shapes.checks()
    gen10 = torch.Generator(device=DEVICE).manual_seed(11)
    n0 = lk_sys.Mmat.shape[0]
    B = shapes.widest("lkdv", n0)
    spmm_err, _ = _check_spmm(
        "lkdv M=100 deg 3 Mmat (catch-up)", lk_sys.Mmat, gen10, (B,),
        operand=lambda B, gen, dtype: _field_view(n0, B, gen, dtype))
    spmm_times = {f"lkdv_M100_deg3_Mmat_B{B}": _time_spmm(
        lk_sys.Mmat, B, "lkdv M=100 deg 3 Mmat (catch-up)", gen10,
        X=_field_view(n0, B, gen10, torch.float64))}
    del lk_sys
    shapes.path(f"swe_M{SWE_M}")
    swe_launches = phase_swe(swe_sys, records["slice1.json"])
    torch.cuda.synchronize()
    ortho_err = phase_ortho_kernel()
    ortho_times = phase_ortho_timing()
    torch.cuda.synchronize()
    fused_launches = phase_swe_fused(swe_sys, records["slice1.json"])
    torch.cuda.synchronize()
    graph_launches = phase_graph_core(swe_sys, records["slice1.json"])
    torch.cuda.synchronize()
    del swe_sys
    shapes.path(f"heat_M{HEAT_M}")
    heat_sys, pre, launches = phase_heat(records["slice2.json"])
    torch.cuda.synchronize()
    shapes.checks()
    st_err, st, dia_heat_err, dia = phase_heat_kernels(heat_sys, pre)
    torch.cuda.synchronize()
    gen9 = torch.Generator(device=DEVICE).manual_seed(10)
    spmm_err = max(spmm_err, _check_spmm(f"heat M={HEAT_M} A", heat_sys.A.dia,
                                         gen9, (8,))[0])
    spmm_times[f"heat_M{HEAT_M}_A_B8"] = _time_spmm(
        heat_sys.A.dia, 8, f"heat M={HEAT_M} A", gen9, heat_sys.A_csr)
    # the catch-up's product: Emat with the (n, jmax) view of the row's
    # first jmax basis rows (n apart, n odd)
    B = shapes.widest(f"heat_M{HEAT_M}", HEAT_N)
    spmm_err = max(spmm_err, _check_spmm(f"heat M={HEAT_M} Emat (catch-up)",
                                         heat_sys.Emat, gen9, (B,))[0])
    spmm_times[f"heat_M{HEAT_M}_Emat_B{B}"] = _time_spmm(
        heat_sys.Emat, B, f"heat M={HEAT_M} Emat (catch-up)", gen9)
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
    shapes.path("heat polynomial rows")
    rows = phase_poly_rows(records["slice3.json"])
    torch.cuda.synchronize()
    anchors = phase_poly_anchors(records["slice3.json"])
    torch.cuda.synchronize()
    snc_launches, _ = phase_snc_row(records["slice4.json"])
    torch.cuda.synchronize()
    evolve_launches, evolve_walls = phase_snc_evolve(records["slice4.json"])
    torch.cuda.synchronize()
    fused_evolve_launches = phase_fused_evolve(
        records["slice4.json"], records["slice8.json"], evolve_walls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk_sys = lkdvrk.linforms(M=400, N=10, degree=3, tstages=2, device=DEVICE)
    print(f"[lkdvrk M=400 (3,2)] assembly {time.perf_counter() - t0:.2f} s")
    shapes.checks()
    dia_rk_err, dia_rk = phase_lkdvrk_kernel(rk_sys)
    spmm_err = max(spmm_err, _check_spmm(f"{LKDVRK_ROWS[0]} A", rk_sys.A, gen9,
                                         (8,))[0])
    spmm_times[f"{LKDVRK_ROWS[0]}_A_B8"] = _time_spmm(
        rk_sys.A, 8, f"{LKDVRK_ROWS[0]} A", gen9, rk_sys.A_csr)
    torch.cuda.synchronize()
    shapes.path("lkdvrk rows")
    rk_rows = phase_lkdvrk_rows(records["slice7.json"])
    torch.cuda.synchronize()
    shapes.checks()
    n0 = rk_sys.Mmat.shape[0]
    B = shapes.widest("lkdvrk rows", n0)
    spmm_err = max(spmm_err, _check_spmm(
        f"{LKDVRK_ROWS[0]} Mmat (catch-up)", rk_sys.Mmat, gen9, (B,),
        operand=lambda B, gen, dtype: _field_view(n0, B, gen, dtype))[0])
    spmm_times[f"{LKDVRK_ROWS[0]}_Mmat_B{B}"] = _time_spmm(
        rk_sys.Mmat, B, f"{LKDVRK_ROWS[0]} Mmat (catch-up)", gen9,
        X=_field_view(n0, B, gen9, torch.float64))
    del rk_sys
    shapes.path(LKDVRK_EVOLVE)
    rk_evolve_launches, _ = phase_lkdvrk_evolve(records["slice7.json"])
    torch.cuda.synchronize()
    shapes.path("lkdv_hard_general")
    general_launches = phase_general()
    torch.cuda.synchronize()
    err9, swe_spmm, batch_rows = phase_batched(records["slice9.json"], shapes)
    spmm_err = max(spmm_err, err9)
    torch.cuda.synchronize()
    print(f"[env] phases took {time.perf_counter() - t_start:.1f} s")

    tpu = "structurepreservingiterativesolvers_tpu/ops/"
    src = "structurepreservingiterativesolvers_torch/csrc/"
    cheb_row, neu_row = (f"heat_M{HEAT_M}_{short}" for short in ("cheb8", "neu4"))
    swe_paths = {f"swe_M{SWE_M}_cgs2_fused": fused_launches,
                 f"swe_M{SWE_M}_graph_core": graph_launches["cgs2"],
                 f"swe_M{SWE_M}_graph_core_cgs2_fused":
                     graph_launches["cgs2_fused"],
                 f"swe_M{SWE_M}_snc": snc_launches,
                 f"swe_M{SWE_M}_snc_evolve": evolve_launches,
                 **fused_evolve_launches}
    rk_paths = {**{name: row["launches"] for name, row in rk_rows.items()},
                f"{LKDVRK_ROWS[0]}_cgs2_fused": rk_rows[LKDVRK_ROWS[0]]["fused"],
                LKDVRK_EVOLVE: rk_evolve_launches,
                "lkdv_hard_general": general_launches}

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
             **{path: n["dia_spmv"] for path, n in swe_paths.items()},
             **{path: n["dia_spmv"] for path, n in rk_paths.items()}}),
         "launches_by_design": {design: launches[f"dia_spmv_{design}"]
                                for design in ("live", "dense")},
         "max_abs_err": max(dia_err, dia_heat_err, dia_rk_err),
         "timed_at": f"heat_M{HEAT_M}_A", **dia,
         "times": {f"swe_M{SWE_M}_A": dia_swe, f"heat_M{HEAT_M}_A": dia,
                   f"{LKDVRK_ROWS[0]}_A": dia_rk}},
        {"name": "stencil_spmv", "route": "cuda",
         "source": src + "stencil_spmv.cu",
         "replaces": f"{tpu}pallas_spmv.py:165",
         "launches": launches["stencil_spmv"],
         "launches_by_design": {design: launches[f"stencil_spmv_{design}"]
                                for design in ("tiled", "flat")},
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
         "launches_by_path": {
             path: n["fused_update_matvec"]
             for path, n in {**swe_paths, **rk_paths}.items()
             if n["fused_update_matvec"]},
         "max_abs_err": ortho_err, "timed_at": head,
         **{key: ortho_times[head][key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "chain_ms")},
         "times": {label: {key: t[key] for key in (
             "ms", "chain_ms", "bound_ms", "warm_ms", "warm_chain_ms")}
             for label, t in ortho_times.items()}})
    # the batched kernel's launches on every path that ran it: the batched
    # rows, and the catch-up's products with a DIA constraint matrix
    # (heat's Emat, lkdv's and lkdvRK's mass matrix) and the general
    # constraint's vmapped products on the host loop and the device core
    spmm_paths = {**{name: row["launches"] for name, row in batch_rows.items()},
                  f"heat_M{HEAT_M}": launches, **lkdv_launches, **rk_paths,
                  **rows, **anchors}
    spmm_paths = {path: n for path, n in spmm_paths.items()
                  if n.get("dia_spmm")}
    head = swe_spmm[8]
    kernels.append(
        {"name": "dia_spmm", "route": "cuda", "source": src + "dia_spmm.cu",
         "replaces": f"{tpu}pallas_spmv.py:91",
         "replaces_under": "structurepreservingiterativesolvers_tpu/"
                           "experiments/batched.py:87 (jax.vmap)",
         "launches": sum(n["dia_spmm"] for n in spmm_paths.values()),
         "launches_by_path": {path: n["dia_spmm"]
                              for path, n in spmm_paths.items()},
         "launches_by_design": {
             design: sum(n[f"dia_spmm_{design}"] for n in spmm_paths.values())
             for design in ("live", "dense", *kd.DESIGNS)},
         "shapes_by_path": shapes.report(),
         "max_abs_err": spmm_err, "timed_at": f"swe_M{SWE_M}_A_B8",
         **{key: head[key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "spmv_launches_ms", "design", "designs_ms")},
         "times": {**{f"swe_M{SWE_M}_A_B{B}": t for B, t in swe_spmm.items()},
                   **spmm_times},
         "walls_ms": batch_rows})
    print("[lkdvrk] " + json.dumps({name: {
        key: row[key] for key in ("format", "width", "ras_blocks", "time_pre",
                                  "time_pre_first", "runtime", "time_gmres",
                                  "cgmres_over_gmres", "wall", "composite")}
        for name, row in rk_rows.items()}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
