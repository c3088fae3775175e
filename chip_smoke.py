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
    plain twin in f64 and f32 for m = 1, 2, 21, 31, 61 and 128 basis rows
    at n = 786,432 (swe M=512), 1,050,625 (heat M=1024, odd), 9,600
    (lkdvRK (3, 2) M=400) and a ragged odd 1,001, with two launches on the
    same input bit-equal and each call one launch of the kernel (the
    profiler), and time it with L2 flushed at swe M=512 (m = 21, 61), heat
    M=1024 (m = 21), heat P2 M=512's n (m = 31) and lkdvRK's n (m = 8) in
    f64 and at swe M=512 (m = 21) in f32, each with ``ortho_plan``'s launch,
    beside its bound and the unfused pair of cuBLAS products, its plain
    twin;
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
    the profiler;
20. (after 19) the eleventh slice, heat under the graph core: the block
    forms of kernels #2, #3 and #4 (#2b, #3b, #4b: ``stencil_spmv.cu``,
    ``poly_tiled.cu`` and ``poly_apply.cu`` with a grid axis over the
    vectors) on heat M=1024's stencil in f64 and f32 at B = 1, 2, 3 and 8,
    over rows n and n + 2 apart (both odd), each design's every column
    bit-equal to the single kernel's launch on it and the dispatch within
    the bound of the plain twin; timed at B = 8 with L2 flushed beside the
    bound, the flat design, B single launches, the plain twin, and for #2b
    today's route (#1b on the explicit DIA) and cuSPARSE SpMM;
21. heat on the device core: the heat M=1024 TimedSolve row with the AMG
    through ``time_cgmres(loop="while")`` held to ``reference/slice2.json``;
    its CGMRES solve on both loops in one call (medians of 5), x within
    1e-10, ``time_capture``, the launches per replay (the V-cycle's DIA
    products inside each ``arnoldi`` graph) and the idle shares; cheb8 and
    neu4 on the device core at the certified anchors (held to
    ``slice3.json``) and at M=1024 (the record's latch and steps, the time
    per iteration of both loops);
22. ``fused_evolve("heat")`` at M=1024 with the AMG, three steps of the
    TimedSolve row's dt (T=0.3): every step certified, drifts within the
    bar, no KKT fallback, step walls beside the host loop's ``evolve`` and
    the idle share;
23. ``cgmres_many`` on heat at B = 8: M=1024 with the AMG, the M=256 anchor
    with cheb8 and the M=64 anchor with neu4, each item certified, its
    steps equal to its single graph-core solve's and x within 1e-10, every
    product of the batch through a block form (#2b, #1b for the V-cycle,
    #3b, #4b) and none through a single kernel, the median wall of 5
    beside the median of 5 rounds of the 8 single solves.
24. (after 16) the twelfth slice, lkdvRK under the graph core, on the
    systems and composites of phase 14: kernel #1 on each row's mass
    matrix and the (3, 2) row's G; each M=400 grid row through
    ``time_cgmres(loop="while")`` held to ``reference/slice7.json``, and
    its CGMRES solve on both loops in one call (medians of 5; x within
    1e-10; the composite's products inside each ``arnoldi`` graph;
    ``time_capture``; idle shares), the (3, 2) row with ``cgs2_fused`` on
    the device core;
25. ``fused_evolve("lkdvrk")`` on the (3, 2) row's evolution (N=10),
    the state carried on the device: every step certified, steps and the
    mass and momentum drifts within the record's, every series equal to
    the host loop's ``evolve`` from the same starts; and the error sweep's
    ``run_single`` on ``loop="while"`` against ``loop="host"``, one device
    core for all its steps;
26. ``cgmres_many`` on the (3, 2) and (5, 4) rows at B = 8 with the
    composite (its RAS one ``torch.bmm`` of the inverses with the block),
    each item certified, its steps its single device-core solve's and x
    within 1e-10, every DIA product of the batch through #1b;
27. lkdv M=100, degree 3 on the device core with the energy as a
    ``GeneralConstraint`` (its Taylor model in the ``kkt_start`` graph) and
    with ``history``, each against the host loop.  After each of 24–27,
    #1b on every (operator, width) the path gave it.
28. (last) the thirteenth slice, heat P2 at M=512 (n = 1,050,625; the
    operator and the constraint matrices ELL of width 19), k=60, tol=1e-7
    absolute, f64, with the greedy host AMG that the default heat
    pre-builder builds from the system's scipy matrix: the TimedSolve row
    through ``time_cgmres`` on both loops (assembly seconds, ``time_pre``
    and ``time_pre_first``, each level's size and format), certified with
    a gain of 2 or more; kernel #1 on every level ``from_scipy`` stores as
    a DIA against its plain twin in f64 and f32, and timed; GMRES and
    CGMRES on both loops (medians of 5; the same steps and latch, x within
    1e-10; the mass and energy deviations beside GMRES's; idle shares and
    the kernels with the most device time; the V-cycle's busy per apply);
    CGMRES with ``ortho="cgs2_fused"`` on both loops (#5 once a step, x
    within 1e-10 of the ``cgs2`` solve);
29. ``cgmres_many`` on heat P2 M=512 at B = 8 (``heat_P2_M512_amg_B8``):
    every item certified, its steps its single device-core solve's, x
    within 1e-10; the V-cycle on the block's rows (#1b on the DIA levels,
    none of #1); then #1b on those levels at the batch's widths, and timed,
    and #5 timed at the row's widest basis;
30. the native host kernels (``utils/native.py``, g++ into
    ``build/native/``) against scipy on a tridiagonal matrix;
31. the row-sharded path (``parallel/``) through NCCL, over a world of
    this process and its card: kernel #1's windowed launch (and #1b's) on
    swe M=512's rows against the unsharded launch (bit for bit on one
    rank) and the plain twin, timed beside #1; swe M=512 (k=60, tol=1e-9)
    unpreconditioned on both loops, with ``cgs2_fused`` on the device core,
    and with the skew-normal Chebyshev (k=20, tol=1e-7), each against the
    unsharded solve in the same call (the same steps and latch, x within
    1e-10); heat M=1024 with the AMG (the fine levels sharded) on the
    device core; a 3-step sharded ``fused_evolve`` on swe M=512 against the
    unsharded one; ``spmv_scaling`` and ``solve_scaling`` at one device;
    walls (medians of 5), idle shares, the collectives' device time and
    their count per solve; on a machine with two or more cards, a
    ``dist-bench`` job of two processes too;
32. the f32 storage mode (``phase_f32``), each row beside its f64 twin in
    this call: the mixed #1 (f32 in, f64 out) against its plain version on
    swe M=512's A and heat M=1024's energy matrix (1e-14 relative); the
    f32 instantiations of #1, the mixed #1, #1b (B = 8), #2, #2b and #5 (m
    = 21) timed at their path shapes with L2 flushed against f32 bounds,
    cuSPARSE f32 beside #1, #1b, #2 and #2b; CGS2's f32 cuBLAS products
    against an f64 product (an f32 error, not TF32's); the swe M=512 row
    with the skew-normal Chebyshev (tol 4e-7·||b||) on both loops with
    ``cgs2`` and ``cgs2_fused``, the heat M=1024 row with the f32 AMG (tol
    1e-6·||b||) on both loops and at tol 1e-7 absolute, each f32 row held
    to the JAX f32 record of its size (``reference/slice15.json``: the
    latch, steps within 2, the certified deviation within max(10x the
    record's, 1e-10 of the invariant's scale), the residual where the
    record's meets tol), launching only f32 instantiations (and, on heat,
    the mixed #1 for the certificates of its energy matrix); a profiled
    device-core solve of each beside its twin and the projection's graph
    alone; a 3-step f32 ``fused_evolve`` on swe M=512; ``cgmres_many`` in
    f32 on the items of ``swe_M512_snc_B8`` and ``heat_M1024_amg_B8``,
    each item's steps its single solve's; the polynomial anchors (heat
    M=256 cheb8, M=64 neu4) in f32 on the device core; an ``[f32]`` JSON
    line of it all.  The f32 ``fused_evolve`` certifies every step, each
    warm-started, in at most one step more than the JAX f32 record's, and
    a warm-started f32 ``evolve`` (host loop) every step.
33. f32 storage on the paths the fifteenth slice left out
    (``phase_f32_rest``), each row beside its f64 twin in this call and,
    where one exists, the JAX f32 record (``reference/slice17.json``):
    lkdvRK M=400 (3, 2) at tol 1e-3 through ``time_cgmres`` on both loops
    with ``cgs2`` and ``cgs2_fused``, (5, 4) at 1e-7 on the device core,
    the systems and RAS + Neumann composites cast from phase 14's f64
    builds; the lkdv hard general solve on both loops; a 10-step f32
    ``fused_evolve("lkdvrk")`` and the error sweep's ``run_single`` in f32
    beside its f64 run; heat P2 M=512 with the greedy AMG cast from phase
    28's, at 1e-4·||b||, on both loops and with ``cgs2_fused``;
    ``cgmres_many`` in f32 on the (3, 2) and heat P2 rows at B = 8; every
    f32 row launching only f32 or mixed instantiations, plus kernel #1 in
    f64 on the StageKron inner's kept upcast mass matrix, counted apart
    (``dia_spmv_upcast``); the kernels at this slice's shapes against their
    plain versions and timed (#1 live and dense and #1b on lkdvRK A, the
    f64 #1 on the upcast mass matrix, #1 and #1b on heat P2 M=256's DIA
    level, the mixed #1 on lkdv M=100's mass matrix, #5 at n = 9,600, m =
    8 and n = 1,050,625, m = 31); an ``[f32-rest]`` JSON line.  Phase 31
    runs the f32 rows of the sharded path (``_sharded_f32``): the windowed
    mixed #1 on swe M=512's A and heat M=1024's energy matrix against its
    plain version and timed, swe M=512 with the skew-normal Chebyshev on
    both loops, heat M=1024 with the AMG on the device core and a 3-step
    f32 ``fused_evolve``, each beside its unsharded f32 solve.
34. CG on the device core (``phase_cg``): heat M=1024 in f64 with the
    structured AMG on the system phases 20-23 built, ``cg(k=200,
    tol=1e-7)`` on both loops (the device core's ``cg_init``, ``cg_step``
    and ``cg_finish`` graphs): equal steps, residual traces within 1e-10
    relative, x within 1e-10 of its max-norm, the true residual below tol,
    x within 1e-6 of the device-core GMRES solutions at tol 1e-7 and
    1e-10; each ``cg_step`` replay launching one stencil product (#2,
    tiled) and the V-cycle's DIA products (#1, dense); walls (medians of
    5) beside the device-core GMRES at the same tol, ``time_capture``,
    busy and idle of one profiled device-core solve; then one f32 solve of
    the row (system and hierarchy cast), its steps within 2 of f64's and
    its true residual within the f32 floor (eps32·‖|A||x| + |b|‖) or tol;
35. the convergence-order study's refinement on the card
    (``phase_order``): lkdvRK at degree 5, M=120, one GL stage, N = 4 and
    8, tol=1e-11, Exact and CGMRES on the device core
    (``scripts/run_error_order_torch.py::final_error``): the observed order
    within 0.4 of 2 for both, CGMRES ≤ 1.05 × Exact, each error within
    1e-9 (Exact) or 1e-6 (CGMRES) relative of the JAX record
    (``reference/slice18.json``).

Every main path checks, by the launch counters, that its DIA products ran
the design its operators' plans pick (live on swe, dense on heat; on an
lkdvRK row the design of A's and the mass matrix's plans where they agree,
else only that kernel #1 ran) and its stencil products the tiled one.  The line before
the last is the kernel report as JSON, the block forms #2b, #3b and #4b
beside the kernels they extend; the last line is the device record.
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
ORTHO_ROWS = (1, 2, 21, 31, 61, 128)
# the widths of kernel #5's checks: swe M=512, heat M=1024 and heat P2
# M=512 (odd), lkdvRK (3, 2) M=400, a ragged odd one, not a multiple of 4
# (every alignment of a row's start in f32), one narrower than a tile and
# one of a single column (plain loads only: no row holds 16 bytes)
LKDVRK_N = 9600
ORTHO_WIDTHS = (SWE_N, HEAT_N, LKDVRK_N, 1001, 31, 1)
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
    """The launch counters of every kernel by name, and of each design of
    kernels #1 to #4, #1b and the block forms #2b, #3b and #4b
    (``<name>_<design>``; #1b's by its operator's plan, live or dense, and
    by its own design), and beside them the collectives of a row-sharded
    solve: the package's ``utils.counters.all_counters``."""
    from structurepreservingiterativesolvers_torch.utils.counters import (
        all_counters,
    )

    return all_counters()


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


def _device_kernels(fn):
    """The names of the device kernels one call of ``fn`` runs, by the
    profiler (after a call outside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            for _ in range(e.count)]


def phase_ortho_kernel():
    """Kernel #5 against its plain twin in f64 and f32 at every basis size
    of ``ORTHO_ROWS`` and at ``ORTHO_WIDTHS`` (swe M=512, heat M=1024 (odd),
    lkdvRK's 9,600, a ragged odd 1,001, 31 and 1), w contiguous from the
    start of its storage and, at m = 21, a view one element into it (an odd
    offset: w and its supersets start off 16 bytes); two launches on the
    same input bit-equal, and each call one launch of the kernel (the
    profiler sees one device kernel, the kernel, a call).  Returns the
    largest f64 absolute error."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import ortho

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    max_abs = 0.0
    for n in ORTHO_WIDTHS:
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).split(".")[-1]
            Q = torch.randn(21, n, generator=gen, device=DEVICE, dtype=dtype)
            w = torch.randn(n, generator=gen, device=DEVICE, dtype=dtype)
            h = torch.randn(21, generator=gen, device=DEVICE, dtype=dtype)
            names = _device_kernels(lambda: ortho.fused_update_matvec(Q, w, h))
            print(f"[ortho] n={n} {tag}, m=21: the device kernels of one "
                  f"call {names}")
            check(len(names) == 1 and "fused_update_matvec" in names[0],
                  f"kernel #5 at n={n} {tag} is not one launch a call: {names}")
            for m in ORTHO_ROWS:
                Q = torch.randn(m, n, generator=gen, device=DEVICE, dtype=dtype)
                buf = torch.randn(n + 1, generator=gen, device=DEVICE,
                                  dtype=dtype)
                h = torch.randn(m, generator=gen, device=DEVICE, dtype=dtype)
                ws = (("", buf[:n]),) + (
                    ((", w a view at offset 1", buf[1:]),) if m == 21 else ())
                for how, w in ws:
                    w1, u2 = ortho.fused_update_matvec(Q, w, h)
                    w1b, u2b = ortho.fused_update_matvec(Q, w, h)
                    torch.cuda.synchronize()
                    ref_w1, ref_u2 = ortho.fused_update_matvec_torch(Q, w, h)
                    err_w1, rel_w1 = _rel_err(w1, ref_w1)
                    err_u2, rel_u2 = _rel_err(u2, ref_u2)
                    same = torch.equal(w1, w1b) and torch.equal(u2, u2b)
                    print(f"[ortho] m={m} n={n} {tag}{how}: max|dw1|/max|w1| "
                          f"= {rel_w1:.3e}, max|du2|/max|u2| = {rel_u2:.3e} "
                          f"(bound {ORTHO_RTOL[tag]:.0e}); repeated launch "
                          f"bit-equal {same}")
                    check(math.isfinite(rel_w1) and math.isfinite(rel_u2)
                          and max(rel_w1, rel_u2) <= ORTHO_RTOL[tag],
                          f"fused CGS2 kernel disagrees with plain at m={m} "
                          f"n={n} {tag}{how}: {rel_w1:.3e}, {rel_u2:.3e}")
                    check(same, f"fused CGS2 kernel not deterministic at m={m} "
                                f"n={n} {tag}{how}")
                    if dtype == torch.float64:
                        max_abs = max(max_abs, err_w1, err_u2)
                del Q, buf
    print(f"[ortho] kernel checks: {time.perf_counter() - t0:.1f} s")
    return max_abs


def _time_ortho(label, n, m, gen, dtype="float64"):
    """Kernel #5 with L2 flushed at (n, m) in ``dtype``, beside its bound
    and its plain twin, which is the unfused pair of cuBLAS products
    (``w − h @ Q``, then ``Q @ w1``); returns the report's fields, with
    ``ortho_plan``'s launch."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import ortho

    dt = getattr(torch, dtype)
    Q = torch.randn(m, n, generator=gen, device=DEVICE, dtype=dt)
    w = torch.randn(n, generator=gen, device=DEVICE, dtype=dt)
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
    nbytes = (m * n + 2 * n) * Q.element_size()
    if dt == torch.float64:
        t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, 4 * m * n)
    else:
        t["bound_ms"], t["bound_by"] = _bound32_ms(nbytes, 4 * m * n)
    t["plan"] = ortho.ortho_plan(m, n, dt)._asdict()
    print(f"[ortho] fused CGS2 update at {label} (n={n}, m={m}, {dtype}, L2 "
          f"flushed, plan {t['plan']}): kernel {t['ms']:.4f} ms "
          f"({nbytes / t['ms'] / 1e6:.0f}"
          f" GB/s of {nbytes / 1e6:.1f} MB), bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}; kernel at {t['bound_ms'] / t['ms']:.1%} of "
          f"it), plain twin = unfused cuBLAS pair {pair:.4f} ms; back to "
          f"back with operands in L2: kernel {t['warm_ms']:.4f} ms, pair "
          f"{t['warm_chain_ms']:.4f} ms")
    return t


def phase_ortho_timing():
    """Kernel #5 at the paths' shapes (``_time_ortho``): f64 at swe M=512
    (m = 21, 61), heat M=1024 (m = 21), heat P2 M=512's n (m = 31) and
    lkdvRK (3, 2) M=400's n (m = 8), f32 at swe M=512 (m = 21).  Returns
    the report's fields of each shape, the swe M=512, m = 21 one first."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    out = {label: _time_ortho(label, n, m, gen, dtype)
           for label, n, m, dtype in (
               (f"swe_M{SWE_M}_m21", SWE_N, 21, "float64"),
               (f"swe_M{SWE_M}_m61", SWE_N, 61, "float64"),
               (f"heat_M{HEAT_M}_m21", HEAT_N, 21, "float64"),
               ("heat_P2_M512_m31", HEAT_N, 31, "float64"),
               ("lkdvrk_M400_deg3_s2_m8", LKDVRK_N, 8, "float64"),
               (f"swe_M{SWE_M}_m21_f32", SWE_N, 21, "float32"))}
    print(f"[ortho] kernel timing: {time.perf_counter() - t0:.1f} s")
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
        core = cg.last_core()
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


def phase_lkdvrk_rows(record, keep=None):
    """The seventh slice's main path: each row of the reference's
    error-sweep grid at M=400 through ``time_cgmres`` with the default
    lkdvRK pre-builder (RAS over 5 blocks, Neumann degree 3), held to
    ``reference/slice7.json``; the composite's device time per apply; and
    the (3, 2) row once more with the fused orthogonalisation.  Returns,
    per row, its numbers and the launches over it; each row's system and
    preconditioner go into ``keep`` where given, for the device-core
    phases."""
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
        if keep is not None:
            keep[name] = (s, pre)
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
    timings and after the last path.  A path started with ``keep`` also
    keeps each operator's launch and the block widths it took, which
    ``_check_path_spmm`` checks after the path."""

    def __init__(self):
        from structurepreservingiterativesolvers_torch.ops import sparse as tsp

        self.by_path, self.running, self.ops = {}, None, {}
        self._sparse, self._launch = tsp, tsp.launch_many

    def _noted(self, rec, X, plan=None):
        from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd

        if plan is None:
            plan = kd.spmm_plan(rec.n, X.shape[1], rec.dtype, rec.strip)
        self.by_path.setdefault(self.running, set()).add(
            (rec.n, X.shape[1], str(rec.dtype).split(".")[-1], plan.design))
        if self.running in self.ops:
            self.ops[self.running].setdefault(
                rec.data_ptr, (rec, set()))[1].add(X.shape[1])
        return self._launch(rec, X, plan)

    def path(self, name, keep=False):
        """Note the batched launches from here on under path ``name``; with
        ``keep`` also their operators."""
        self.running = name
        if keep:
            self.ops.setdefault(name, {})
        self._sparse.launch_many = self._noted

    def operators(self, path):
        """The operators ``path`` (started with ``keep``) gave the batched
        kernel, each as (launch, widths), handed over once."""
        return list(self.ops.pop(path, {}).values())

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


def _check_path_spmm(shapes, path, gen):
    """#1b on every operator of ``path`` at every block width the path gave
    it (``SpmmShapes`` kept them), in the path's dtype, through
    ``_check_spmm``: against the plain twin, every design, layout and repeat
    bit-equal, and each column bit-equal to kernel #1.  Returns the largest
    f64 absolute error and the (operator, width) pairs checked."""
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA

    err, pairs = 0.0, 0
    for rec, widths in shapes.operators(path):
        ndiag = rec.many[0]
        A = DIA(data=rec.keep[0],
                offsets=tuple(int(o) for o in rec.many[1][:ndiag]),
                shape=(rec.n, rec.n), wrap=bool(rec.many[2]))
        tag = str(rec.dtype).split(".")[-1]
        err = max(err, _check_spmm(f"{path} operator", A, gen, sorted(widths),
                                   dtypes=(tag,))[0])
        pairs += len(widths)
    check(pairs > 0, f"{path}: no batched launch to check")
    print(f"[spmm] {path}: {pairs} (operator, width) pairs of the path "
          f"checked")
    return err, pairs


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
        core = cg.last_core()
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
        names = {id(fn): nm for nm, fn in _launch_counters().items()}
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


# the eleventh slice: heat on the device core.  The block forms #2b, #3b and
# #4b are checked at these widths, each over rows n and n + 2 apart (both
# odd at heat M=1024, n = 1,050,625), and timed at B = 8
BLOCK_BATCHES = (1, 2, 3, 8)
HEAT_B = 8
# the batched heat rows: (name, M, k, preconditioner), item i the system's
# step_update(z0 + 0.02 i·p), p the smooth field of the lowest 3 x 3 cosine
# modes (scripts/make_torch_reference.py::heat_smooth_field)
HEAT_BATCH_ROWS = (("heat_M1024_amg_B8", HEAT_M, HEAT_K, "amg"),
                   ("heat_M256_cheb8_B8", 256, 60, "cheb8"),
                   ("heat_M64_neu4_B8", 64, 60, "neu4"))


def _heat_block(n, B, gen, dtype, pad=0):
    """B vectors as the rows of a (B, n + pad) block, through the (n, B)
    view of its first n columns: rows n + pad apart."""
    import torch

    V = torch.randn(B, n + pad, generator=gen, device=DEVICE, dtype=dtype)
    return V[:, :n].T


def _heat_pre(short, s):
    """The preconditioner of a heat row: the AMG of the TimedSolve
    pre-builder, or the third slice's polynomial builders."""
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )

    if short == "amg":
        return default_pre_builder("heat")(s)
    return _poly_builders()[short](s)


def phase_block_kernels(s):
    """The block forms of kernels #2, #3 and #4 (#2b, #3b, #4b) on heat
    M=1024's stencil in f64 and f32, at B = 1, 2, 3 and 8 over rows n and
    n + 2 apart: each design (tiled and flat) launched on the block, each
    column bit-equal to the single kernel's launch on that vector in the
    same design; the dispatch (the design ``stencil_plan`` or ``poly_plan``
    picks) within the bound of the plain twin; then each timed at B = 8 in
    f64 with L2 flushed beside its bound, the flat design, the plain twin,
    B launches of the single kernel (for #3b and #4b in either design), and
    for #2b today's route (#1b on the explicit DIA) and cuSPARSE SpMM.  Returns per kernel its largest f64
    error and its report fields."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks
    from structurepreservingiterativesolvers_torch.precond import (
        chebyshev,
        neumann,
    )

    S = s.A
    n, ndiag = S.shape[0], len(S.offsets)
    R = n // S.grid_c
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    base = chebyshev(S, degree=CHEB_DEGREE)
    theta = 0.5 * (base.lmax + base.lmin)
    delta = 0.5 * (base.lmax - base.lmin)
    dinv64 = neumann(S, degree=NEU_DEGREE, omega=NEU_OMEGA).dinv
    tile = ks.StencilTile(*ks.TILE)
    errs = {"stencil_spmm": 0.0, "cheb_apply_many": 0.0,
            "neumann_apply_many": 0.0}

    def poly_args(kind, Sd, dinv):
        if kind == "cheb":
            return (CHEB_DEGREE, theta, delta, theta / delta)
        return (dinv, NEU_DEGREE, NEU_OMEGA)

    def stencil_design(design, ops):
        if design == "tiled":
            return lambda X: (ks.stencil_spmm_tiled_cuda if X.dim() == 2
                              else ks.stencil_spmv_tiled_cuda)(
                ops[0], ops[1], ops[3], ops[4], tile, X)
        return lambda X: (ks.stencil_spmm_flat_cuda if X.dim() == 2
                          else ks.stencil_spmv_flat_cuda)(*ops, X)

    def poly_design(kind, design, Sd, scal):
        fn = getattr(pa, f"{kind}_apply_{design}_cuda")
        lead = ((Sd, pa.poly_plan(Sd, kind, scal[0 if kind == "cheb" else 1],
                                  Sd.dtype))
                if design == "tiled" else (Sd,))
        return lambda X: fn(*lead, *scal, X)

    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]
        Sd, dinv = S.astype(dtype), dinv64.to(dtype)
        ops = (Sd.const, Sd.offsets, Sd.wrap, Sd.grid_c, Sd.strips)
        for B in BLOCK_BATCHES:
            for pad in (0, 2):
                X = _heat_block(n, B, gen, dtype, pad)
                cols = [X[:, b].contiguous() for b in range(B)]
                label = f"heat M={HEAT_M} B={B} rows {n + pad} apart {tag}"
                for design in ("tiled", "flat"):
                    run = stencil_design(design, ops)
                    Y = run(X)
                    torch.cuda.synchronize()
                    check(all(torch.equal(Y[:, b], run(c))
                              for b, c in enumerate(cols)),
                          f"#2b {design} {label}: a column differs from "
                          f"kernel #2")
                    for kind in ("cheb", "neumann"):
                        scal = poly_args(kind, Sd, dinv)
                        run = poly_design(kind, design, Sd, scal)
                        Y = run(X)
                        torch.cuda.synchronize()
                        check(all(torch.equal(Y[:, b], run(c))
                                  for b, c in enumerate(cols)),
                              f"#{3 if kind == 'cheb' else 4}b {design} "
                              f"{label}: a column differs from the single "
                              f"kernel")
                before = (ks.stencil_spmm_tiled_cuda.launches,
                          ks.stencil_spmm_cuda.launches,
                          ks.stencil_spmv_cuda.launches)
                Y = Sd @ X
                torch.cuda.synchronize()
                check((ks.stencil_spmm_tiled_cuda.launches,
                       ks.stencil_spmm_cuda.launches,
                       ks.stencil_spmv_cuda.launches)
                      == (before[0] + 1, before[1] + 1, before[2]),
                      f"#2b {label}: S @ X did not launch the tiled block "
                      f"design once")
                abs_err, rel = _rel_err(Y, ks.stencil_spmm_torch(*ops, X))
                check(rel <= KERNEL_RTOL[tag],
                      f"#2b {label} against the plain twin: {rel:.3e}")
                line = [f"#2b {rel:.1e}"]
                if dtype == torch.float64:
                    errs["stencil_spmm"] = max(errs["stencil_spmm"], abs_err)
                for kind, name in (("cheb", "cheb_apply_many"),
                                   ("neumann", "neumann_apply_many")):
                    scal = poly_args(kind, Sd, dinv)
                    counter = getattr(pa, f"{name}_tiled_cuda")
                    before = counter.launches
                    Y = getattr(pa, f"{kind}_apply")(Sd, *scal, X)
                    torch.cuda.synchronize()
                    check(counter.launches == before + 1,
                          f"{name} {label}: the dispatch did not launch the "
                          f"tiled block design")
                    abs_err, rel = _rel_err(
                        Y, getattr(pa, f"{kind}_apply_torch")(Sd, *scal, X))
                    check(rel <= POLY_RTOL[tag],
                          f"{name} {label} against the plain twin: {rel:.3e}")
                    line.append(f"#{3 if kind == 'cheb' else 4}b {rel:.1e}")
                    if dtype == torch.float64:
                        errs[name] = max(errs[name], abs_err)
                print(f"[block] {label}: tiled and flat designs bit-equal to "
                      f"the single kernels column by column; the dispatch "
                      f"against the plain twin, max|dY|/max|Y|: "
                      + ", ".join(line))

    # times at B = 8, f64, L2 flushed
    B = HEAT_B
    X = _heat_block(n, B, gen, torch.float64)
    cols = [X[:, b].contiguous() for b in range(B)]
    ops = (S.const, S.offsets, S.wrap, S.grid_c, S.strips)
    Acsr = _csr(s.A_csr)
    Xc = X.contiguous()
    strip_bytes = 2 * (S.grid_c + R) * ndiag * 8
    _, rel = _rel_err(S @ X, torch.sparse.mm(Acsr, Xc))
    check(rel <= 1e-13, f"#2b and cuSPARSE SpMM differ: {rel:.3e}")
    st = {"B": B, "design": "tiled",
          "ms": _time_cold_ms(lambda: S @ X),
          "flat_ms": _time_cold_ms(lambda: ks.stencil_spmm_flat_cuda(*ops, X)),
          "spmv_launches_ms": _time_cold_ms(lambda: [S @ c for c in cols]),
          "dia_spmm_ms": _time_cold_ms(lambda: S.dia @ X),
          "library_ms": _time_cold_ms(lambda: torch.sparse.mm(Acsr, Xc)),
          "plain_ms": _time_cold_ms(lambda: ks.stencil_spmm_torch(*ops, X),
                                    reps=10)}
    st["bound_ms"], st["bound_by"] = _bound_ms(2 * B * n * 8 + strip_bytes,
                                               2 * ndiag * n * B)
    print(f"[block] #2b at heat M={HEAT_M}, B={B} (f64, L2 flushed): tiled "
          f"{st['ms']:.4f} ms, flat {st['flat_ms']:.4f} ms, bound "
          f"{st['bound_ms']:.4f} ms ({st['bound_by']}; tiled at "
          f"{st['bound_ms'] / st['ms']:.1%} of it); today's route, #1b on "
          f"the explicit DIA, {st['dia_spmm_ms']:.4f} ms; {B} launches of #2 "
          f"{st['spmv_launches_ms']:.4f} ms; cuSPARSE SpMM "
          f"{st['library_ms']:.4f} ms; plain {st['plain_ms']:.4f} ms")
    p, q = CHEB_DEGREE, NEU_DEGREE
    out = {"stencil_spmm": st}
    dinv = dinv64
    for kind, name, nbytes, nflop in (
            # as phase_poly_timing counts one apply, for B vectors; D⁻¹ and
            # the strips read once for the block
            ("cheb", "cheb_apply_many", 2 * B * n * 8 + strip_bytes,
             B * n * ((2 * ndiag + 3) + (p - 1) * (2 * ndiag + 5) + 1)),
            ("neumann", "neumann_apply_many", (2 * B + 1) * n * 8 + strip_bytes,
             B * n * ((2 * ndiag + 6) + (q - 2) * (2 * ndiag + 4)))):
        scal = poly_args(kind, S, dinv)
        apply = getattr(pa, f"{kind}_apply")
        flat = getattr(pa, f"{kind}_apply_flat_cuda")
        plan = pa.poly_plan(S, kind, scal[0 if kind == "cheb" else 1],
                            torch.float64)
        t = {"B": B, "design": "tiled",
             "plan": {"tile": [plan.tile_r, plan.tile_c], "halo": plan.sweeps},
             "ms": _time_cold_ms(lambda: apply(S, *scal, X)),
             "flat_ms": _time_cold_ms(lambda: flat(S, *scal, X)),
             "single_launches_ms": _time_cold_ms(
                 lambda: [apply(S, *scal, c) for c in cols]),
             "flat_single_launches_ms": _time_cold_ms(
                 lambda: [flat(S, *scal, c) for c in cols]),
             "plain_ms": _time_cold_ms(
                 lambda: getattr(pa, f"{kind}_apply_torch")(S, *scal, X),
                 reps=5),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, nflop)
        out[name] = t
        print(f"[block] #{3 if kind == 'cheb' else 4}b {name} at heat "
              f"M={HEAT_M}, B={B} (f64, L2 flushed): tiled {t['ms']:.4f} ms "
              f"(tile {plan.tile_r}x{plan.tile_c}, halo {plan.sweeps}), flat "
              f"{t['flat_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; tiled at {t['bound_ms'] / t['ms']:.1%} of "
              f"it); {B} launches of the single kernel "
              f"{t['single_launches_ms']:.4f} ms (flat "
              f"{t['flat_single_launches_ms']:.4f} ms); plain "
              f"{t['plain_ms']:.4f} ms")
    return errs, out


def _timed(fn, reps=GRAPH_SOLVES):
    """``fn``'s result and the walls of ``reps`` calls, each synchronised."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def _median(walls):
    return sorted(walls)[len(walls) // 2]


def _ms(walls):
    return ", ".join(f"{1e3 * w:.3f}" for w in walls)


def _replayed(runner, before):
    """The launches by counter name of the replays since ``before`` (the
    runner's ``replayed`` then): each graph's launches times its replays."""
    names = {id(fn): nm for nm, fn in _launch_counters().items()}
    out = {nm: 0 for nm in _launch_counters()}
    for key, (_, counts) in runner.graphs.items():
        for counter, nl in counts:
            out[names[id(counter)]] += nl * (runner.replayed.get(key, 0)
                                             - before.get(key, 0))
    return out


def phase_heat_graph(slice2, slice3):
    """heat on the device core, one solve.  The heat M=1024 TimedSolve row
    with the AMG through ``time_cgmres(loop="while")`` (both solvers on the
    device core, as the JAX package's), held to ``reference/slice2.json``;
    then its CGMRES solve alone on both loops in this call, medians of 5,
    held to the record and to each other (x within 1e-10), with
    ``time_capture``, the launches per replay (the V-cycle's 28 DIA
    products in each ``arnoldi`` graph) and of one solve (each graph's
    launches times its replays), and the idle share of each loop under the
    profiler.  Then cheb8 and neu4 on the device core: at the certified
    anchors (``ANCHORS``) held to ``reference/slice3.json`` as phase 9 holds
    the host loop, and at heat M=1024, where they stall, to the record's
    latch and steps, with the time per iteration of both loops.  Returns
    the launches of each path and the walls."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
        time_cgmres,
    )
    from structurepreservingiterativesolvers_torch.models import heat

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    seen = {}

    def pre_builder(system):  # the default, keeping what it was given
        seen["system"] = system
        seen["pre"] = default_pre_builder("heat")(system)
        return seen["pre"]

    tag = f"[heat_M{HEAT_M}_graph_core]"
    _reset_launches()
    row = time_cgmres("heat", M=HEAT_M, k=HEAT_K, tol=HEAT_TOL,
                      pre_builder=pre_builder, device=DEVICE, loop="while")
    torch.cuda.synchronize()
    row_launches = _read_launches()
    s, pre = seen["system"], seen["pre"]
    rec = slice2[f"heat_M{HEAT_M}"]
    print(f"{tag} time_cgmres(loop='while'): gmres {row['gmres_steps']} steps "
          f"(record {rec['gmres']['steps']}) {1e3 * row['time_gmres']:.3f} ms; "
          f"cgmres {row['steps']} steps, {row['constrained_steps']} "
          f"constrained (record {rec['cgmres']['steps']} / "
          f"{rec['cgmres']['constrained_steps']}), safety {row['safety']}, "
          f"runtime {1e3 * row['runtime']:.3f} ms (phase 1 "
          f"{1e3 * row['iter_time_unconstrained']:.3f} ms/iteration, catch-up "
          f"{1e3 * row['constraint_building']:.3f} ms, endgame "
          f"{1e3 * row['iter_time_constrained']:.3f} ms/iteration), "
          f"time_capture {row['time_capture']:.3f} s; AMG setup "
          f"{row['time_pre']:.4f} s; warm-up pass (captures) "
          f"{row['compile_time']:.3f} s; launches over the row "
          f"{ {k: v for k, v in row_launches.items() if v} }")
    check(row["safety"] is True, f"{tag} the row's safety {row['safety']}")
    check(abs(row["gmres_steps"] - rec["gmres"]["steps"]) <= 1,
          f"{tag} the row's gmres steps {row['gmres_steps']}")
    _check_counts(tag + " row", row, rec["cgmres"],
                  ("steps", "constrained_steps"))
    check(max(row["conservation"][f"cgmres_{nm}"]
              for nm in row["invariant_names"]) <= DEVIATION_MAX,
          f"{tag} the row's deviations {row['conservation']}")

    cons = s.constraints()
    kw = dict(k=HEAT_K, tol=HEAT_TOL, pre=pre, constraints=cons)

    def host():
        return cg.cgmres(s.A, s.b, **kw)

    def graphs(timing=False):
        return cg.cgmres(s.A, s.b, loop="while", timing=timing, **kw)

    xg, ig = graphs(timing=True)
    core = cg.last_core()
    runner = core.runner
    before = dict(runner.replayed)
    _reset_launches()
    x2, i2 = graphs()
    torch.cuda.synchronize()
    launches = _read_launches()
    expected = _replayed(runner, before)
    per_replay = runner.launches()
    (xh, ih), host_walls = _timed(host)
    _, graph_walls = _timed(graphs)
    hp, gp = _profiled(host), _profiled(graphs)
    res = float(torch.linalg.norm(s.b - s.A @ xg))
    hmed, med = _median(host_walls), _median(graph_walls)
    levels = sum(1 for L in pre.levels if L.P is not None)
    print(f"{tag} cgmres on the device core: steps {ig['steps']} (record "
          f"{rec['cgmres']['steps']}), constrained {ig['constrained_steps']}, "
          f"safety {ig['safety']}, KKT deviation {ig['deviation']:.3e}, true "
          f"residual {res:.4e}; host loop steps {ih['steps']}; x against the "
          f"host loop {_rel(xg, xh):.3e}; a second solve bit-equal "
          f"{bool(torch.equal(xg, x2))}")
    print(f"{tag} wall, median of {GRAPH_SOLVES}: host loop {1e3 * hmed:.3f} "
          f"ms ({_ms(host_walls)}), device core {1e3 * med:.3f} ms "
          f"({_ms(graph_walls)}); time_capture {runner.time_capture:.3f} s "
          f"({runner.captures} graphs, captured by the row's warm-up); "
          f"profiled: host loop busy {hp[1]:.3f} ms, idle {hp[2]:.3f}; device "
          f"core busy {gp[1]:.3f} ms, idle {gp[2]:.3f}; busy over the "
          f"unprofiled medians: host loop {1.0 - hp[1] / 1e3 / hmed:.3f} idle, "
          f"device core {1.0 - gp[1] / 1e3 / med:.3f} idle")
    print(f"{tag} launches over one solve {launches}; per replay by graph "
          f"{per_replay}")
    check(ig["safety"] is True and i2["safety"] is True, f"{tag} safety")
    _check_counts(tag, ig, rec["cgmres"], ("steps", "constrained_steps"))
    check(ig["deviation"] <= DEVIATION_MAX, f"{tag} KKT deviation "
                                            f"{ig['deviation']:.3e}")
    check(math.isfinite(res) and res < HEAT_TOL, f"{tag} true residual "
                                                 f"{res:.3e}")
    check(_rel(xg, xh) <= 1e-10, f"{tag} x {_rel(xg, xh):.3e} from the host "
                                 f"loop")
    check(torch.equal(xg, x2), f"{tag} a second replayed solve differs")
    check(launches == expected, f"{tag} launches {launches} are not the "
                                f"replays' {expected}")
    check(per_replay["arnoldi"].get("dia_spmv") == 7 * levels
          and per_replay["arnoldi"].get("stencil_spmv") == 1,
          f"{tag} an arnoldi graph holds {per_replay['arnoldi']}, not the "
          f"V-cycle's {7 * levels} DIA products and one stencil product")
    for kernel in ("dia_spmv", "stencil_spmv"):
        _check_design(tag, launches, kernel, designs=HEAT_DESIGNS)
    kernels = sorted(nm for nm in gp[3] if "dia_spmv" in nm or "stencil" in nm)
    check(any("dia_spmv" in nm for nm in kernels)
          and any("stencil" in nm for nm in kernels),
          f"{tag} the profiler saw {kernels} in the replays")
    paths = {f"heat_M{HEAT_M}_graph_core_row": row_launches,
             f"heat_M{HEAT_M}_graph_core": launches}
    walls = {f"heat_M{HEAT_M}_amg": {"graph_ms": 1e3 * med,
                                     "host_ms": 1e3 * hmed,
                                     "capture_s": runner.time_capture,
                                     "idle": gp[2], "host_idle": hp[2]}}
    cg.clear_core_cache()

    builders = _poly_builders()
    polys = [(name, M, k, short, slice3[name]) for name, M, k, short in ANCHORS]
    polys += [(f"heat_M{HEAT_M}_{short}", HEAT_M, HEAT_K, short,
               slice3[f"heat_M{HEAT_M}_{short}"]) for short in ("cheb8", "neu4")]
    for name, M, k, short, prec in polys:
        tag = f"[{name} graph_core]"
        sp = s if M == HEAT_M else heat.linforms(M=M, device=DEVICE)
        p = builders[short](sp)
        _check_bounds(tag, p, prec)
        pkw = dict(k=k, tol=HEAT_TOL, pre=p, constraints=sp.constraints())
        xg, ig = cg.cgmres(sp.A, sp.b, loop="while", timing=True, **pkw)
        _reset_launches()
        (x2, i2), gw = _timed(lambda: cg.cgmres(
            sp.A, sp.b, loop="while", timing=True, **pkw), reps=1)
        torch.cuda.synchronize()
        launches = _read_launches()
        (xh, ih), hw = _timed(lambda: cg.cgmres(sp.A, sp.b, **pkw), reps=1)
        r = prec["cgmres"]
        res = float(torch.linalg.norm(sp.b - sp.A @ x2))
        per_it = i2["timings"]["runtime"] / i2["steps"]
        kernel = "cheb_apply" if short.startswith("cheb") else "neumann_apply"
        print(f"{tag} steps {i2['steps']}, constrained "
              f"{i2['constrained_steps']}, safety {i2['safety']} (record "
              f"{r['steps']} / {r['constrained_steps']} / {r['safety']}; host "
              f"loop {ih['steps']} / {ih['constrained_steps']} / "
              f"{ih['safety']}), KKT deviation {i2['deviation']:.3e}, true "
              f"residual {res:.4e} (record {r['true_residual']:.4e}); wall "
              f"{1e3 * gw[0]:.3f} ms, {1e3 * per_it:.3f} ms/iteration on the "
              f"device core; host loop {1e3 * hw[0]:.3f} ms, "
              f"{1e3 * hw[0] / ih['steps']:.3f} ms/iteration; x against the "
              f"host loop {_rel(x2, xh):.3e}; {kernel} launches "
              f"{launches[kernel]}")
        check(i2["safety"] == r["safety"], f"{tag} safety {i2['safety']} vs "
                                           f"record {r['safety']}")
        _check_design(tag, launches, kernel)
        _check_design(tag, launches, "stencil_spmv")
        check(launches[kernel] == i2["steps"],
              f"{tag} {launches[kernel]} {kernel} launches over "
              f"{i2['steps']} steps")
        if M == HEAT_M:  # the stalled rows: the record's latch and steps
            check(i2["steps"] == r["steps"], f"{tag} steps {i2['steps']} vs "
                                             f"record {r['steps']}")
        else:  # the certified anchors, as phase 9 holds the host loop
            _check_counts(tag, i2, r, ("steps", "constrained_steps"))
            check(i2["deviation"] <= DEVIATION_MAX, f"{tag} KKT deviation "
                                                    f"{i2['deviation']:.3e}")
            if r["true_residual"] < HEAT_TOL:
                check(res < HEAT_TOL, f"{tag} true residual {res:.3e}")
            check(_rel(x2, xh) <= 1e-10, f"{tag} x {_rel(x2, xh):.3e} from "
                                         f"the host loop")
        paths[f"{name}_graph_core"] = launches
        walls[name] = {"graph_ms_per_iteration": 1e3 * per_it,
                       "host_ms_per_iteration": 1e3 * hw[0] / ih["steps"]}
        cg.clear_core_cache()
    return paths, walls


def phase_heat_fused_evolve(s0):
    """``fused_evolve`` on heat M=1024, three steps of the TimedSolve row's
    dt (T=0.3, N=3: dt = 0.1, the row's operator), warm-started, with the
    AMG built on the first system, at the row's k and tol: every step
    certified, its mass and energy drifts within the certificate's bar, no
    KKT fallback, kernel #1 in the design its operators' plans pick, the
    counters the replays' launches; its step walls beside the host loop's
    ``evolve`` of the same steps in this call, and its idle share under
    the profiler.  ``s0``: heat's M=1024 system at that dt (the default
    N=100, T=10), whose operators the evolution's are, so the AMG is built
    on it.  Returns its launches and the walls."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        evolve,
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )

    params = dict(M=HEAT_M, N=EVOLVE_N, T=EVOLVE_T)
    tag = f"[fused_evolve heat_M{HEAT_M}]"
    check(math.isclose(s0.prob.dt, EVOLVE_T / EVOLVE_N),
          f"{tag} the system's dt {s0.prob.dt} is not the evolution's")
    pre = default_pre_builder("heat")(s0)

    def run():
        return fused_evolve("heat", k=HEAT_K, tol=HEAT_TOL, pre=pre,
                            device=DEVICE, **params)

    _reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = _read_launches()
    t = out["timings"]
    starts = []

    def solver(system, **kw):  # the start of each step's solve
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return wrappers.cgmres_wrapper(system, **kw)

    host = evolve("heat", k=HEAT_K, tol=HEAT_TOL, pre=pre, warm_start=True,
                  solver=solver, device=DEVICE, **params)
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    host_walls = [b - a for a, b in zip(starts, starts[1:])]
    box = {}
    prof = _profiled(lambda: box.setdefault("out", run()))[4]
    wall, busy, names = _window_busy(prof, "fused_evolve steps")
    cap = 1e3 * box["out"]["timings"]["time_capture"]
    print(f"{tag} steps {list(map(int, out['steps']))} (host loop "
          f"{host['steps']}), safety {list(map(int, out['safety']))} (host "
          f"loop {host['safety']}), fallbacks "
          f"{list(map(int, out['fallbacks']))}; mass {list(out['mass'])}, "
          f"drift dm {list(out['dm'])}; energy (the dissipation identity) "
          f"{list(out['energy'])}; host loop dm {list(host['dm'])}, de "
          f"{list(host['de'])}")
    print(f"{tag} step walls {_ms(t['step_wall'])} ms, of them capture "
          f"{_ms(t['step_capture'])} ms; host-loop evolve step walls "
          f"{_ms(host_walls)} ms; profiled warm evolution: wall {wall:.3f} ms, "
          f"capture {cap:.3f} ms, busy {busy:.3f} ms, idle share of the wall "
          f"less capture {1.0 - busy / (wall - cap):.3f}")
    print(f"{tag} launches over the evolution {launches}; per replay by graph "
          f"{t['launches_per_replay']}")
    check(len(out["steps"]) == EVOLVE_N, f"{tag} ran {len(out['steps'])} steps")
    check(all(int(sf) == 1 for sf in out["safety"]), f"{tag} safety "
                                                     f"{out['safety']}")
    check(not out["fallbacks"].any(), f"{tag} KKT fallbacks "
                                      f"{out['fallbacks']}")
    check(all(d <= DEVIATION_MAX for d in out["dm"])
          and all(d <= DEVIATION_MAX for d in out["de"]),
          f"{tag} drifts dm {out['dm']}, de {out['de']}")
    check(all(abs(int(a) - int(b)) <= 1
              for a, b in zip(out["steps"], host["steps"])),
          f"{tag} steps {out['steps']} vs the host loop's {host['steps']}")
    check(bool(torch.isfinite(out["sol"]).all()), f"{tag} solution not finite")
    replayed = {nm: t["launches"].get(nm, 0) for nm in launches}
    check(launches == replayed, f"{tag} launches {launches} are not the "
                                f"replays' {replayed}")
    # step_update's products with Mmat and Lmat, the V-cycle's, the
    # endgame's with Emat: their plans need not agree
    _check_dia_path(tag, launches, (s0.Mmat, s0.Lmat, s0.Emat,
                                    *_amg_operators(pre).values()))
    _check_design(tag, launches, "stencil_spmv")
    check(any("stencil" in nm for nm in names)
          and any("dia_spmv" in nm for nm in names),
          f"{tag} the profiler saw no kernels #1 and #2 in the replays")
    return {f"heat_M{HEAT_M}_fused_evolve": launches}, {
        "step_ms": [1e3 * w for w in t["step_wall"]],
        "host_step_ms": [1e3 * w for w in host_walls],
        "idle": 1.0 - busy / (wall - cap)}


def _check_block_row(tag, s, pre, short, gen):
    """The block kernels of a batched heat row on the row's own operators
    at B = HEAT_B, on the (n, B) view of a (B, n) block as the core reads
    it: #2b's ``A @ X``, and for cheb8 (neu4) the preconditioner's apply,
    #3b (#4b).  Each launches once in its block counter, agrees with its
    plain twin within the bound, and gives each column the single kernel's
    bits on that vector.  Returns per kernel its largest absolute error."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import (
        launch_counters,
    )
    from structurepreservingiterativesolvers_torch.kernels import poly_apply as pa
    from structurepreservingiterativesolvers_torch.kernels import stencil_spmv as ks

    S = s.A
    n = S.shape[0]
    X = _heat_block(n, HEAT_B, gen, torch.float64)
    ops = (S.const, S.offsets, S.wrap, S.grid_c, S.strips)
    runs = {"stencil_spmm": (lambda V: S @ V,
                             lambda V: ks.stencil_spmm_torch(*ops, V),
                             KERNEL_RTOL)}
    if short == "cheb8":
        theta = 0.5 * (pre.lmax + pre.lmin)
        delta = 0.5 * (pre.lmax - pre.lmin)
        runs["cheb_apply_many"] = (pre, lambda V: pa.cheb_apply_torch(
            pre.A, pre.degree, theta, delta, theta / delta, V), POLY_RTOL)
    elif short == "neu4":
        runs["neumann_apply_many"] = (pre, lambda V: pa.neumann_apply_torch(
            pre.A, pre.dinv, pre.degree, pre.omega, V), POLY_RTOL)
    counters, errs = launch_counters(), {}
    for name, (run, plain, rtol) in runs.items():
        before = counters[name].launches
        Y = run(X)
        torch.cuda.synchronize()
        check(counters[name].launches == before + 1,
              f"{tag} {name}: the block did not launch the block form once")
        errs[name], rel = _rel_err(Y, plain(X))
        cols = torch.stack([run(X[:, b].contiguous())
                            for b in range(HEAT_B)], 1)
        torch.cuda.synchronize()
        print(f"[block] {tag} {name} at the row's operator (n={n}, "
              f"B={HEAT_B}, f64): max|dY|/max|Y| = {rel:.3e} against the "
              f"plain twin (bound {rtol['float64']:.0e}); columns bit-equal "
              f"to the single kernel {torch.equal(Y, cols)}")
        check(rel <= rtol["float64"],
              f"{tag} {name} against the plain twin: {rel:.3e}")
        check(torch.equal(Y, cols),
              f"{tag} {name}: a column differs from the single kernel")
    return errs


def phase_heat_batched(s1024, row):
    """``cgmres_many`` on heat at B = 8, the row ``row`` of
    ``HEAT_BATCH_ROWS`` (M=1024 with the AMG, the M=256 anchor with cheb8,
    the M=64 anchor with neu4; ``s1024`` heat's M=1024 system), item i
    the system's ``step_update(z0 + 0.02 i·p)``: every item certified
    (latch 1, KKT deviation within the bar, and the true residual below tol
    where its single solve converges), its steps equal to its single
    graph-core solve's and x within 1e-10 of it; every product of the
    batch through the block forms (#2b for A, #1b for the V-cycle's levels,
    #3b or #4b for a polynomial) and none through a single kernel; the
    counters the replays' launches; the median wall of 5 batched solves
    beside the median of 5 rounds of the 8 single solves, ``time_capture``
    and the idle share under the profiler.  Returns per row its launches
    and walls."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_torch.models import heat

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    ref = _reference_script()
    rows = {}
    for name, M, k, short in HEAT_BATCH_ROWS:
        if name != row:
            continue
        tag = f"[{name}]"
        s = s1024 if M == HEAT_M else heat.linforms(M=M, device=DEVICE)
        pre = _heat_pre(short, s)
        field = torch.as_tensor(ref.heat_smooth_field(M, s.z0.cpu().numpy()),
                                device=DEVICE)
        items = [s.step_update(s.z0 + 0.02 * i * field) for i in range(HEAT_B)]
        Bs = torch.stack([t.b for t in items])
        cons = [t.constraints() for t in items]

        def many():
            return cgmres_many(s.A, Bs, cons, k=k, tol=HEAT_TOL, pre=pre)

        (X, info), first = _timed(many, reps=1)
        runner = cg.last_core().runner
        capture = runner.time_capture
        _, walls = _timed(many)
        before = dict(runner.replayed)
        _reset_launches()
        X2, info2 = many()
        torch.cuda.synchronize()
        launches = _read_launches()
        expected = _replayed(runner, before)
        per_replay = runner.launches()
        prof = _profiled(many)
        span_wall, span_busy, span_names = _window_busy(prof[4], "cgmres_many")
        cg.clear_core_cache()

        def singles():
            return [cg.cgmres(s.A, t.b, k=k, tol=HEAT_TOL, pre=pre,
                              constraints=c, loop="while")
                    for t, c in zip(items, cons)]

        singles()  # the first item's solve captures the graphs
        one, single_walls = _timed(singles)
        cg.clear_core_cache()
        med, smed = _median(walls), _median(single_walls)
        true_res = [float(torch.linalg.norm(t.A @ x - t.b))
                    for t, x in zip(items, X)]
        x_rel = [_rel(X[i], xs) for i, (xs, _) in enumerate(one)]
        print(f"{tag} B={HEAT_B}, k={k}: steps {list(map(int, info['steps']))}"
              f" (single solves {[i1['steps'] for _, i1 in one]}), safety "
              f"{list(map(int, info['safety']))}, KKT deviation "
              f"{['%.2e' % d for d in info['deviation']]}, true residual "
              f"{['%.2e' % r for r in true_res]}; x against each single "
              f"solve {['%.2e' % r for r in x_rel]}; a second batched solve "
              f"bit-equal {bool(torch.equal(X, X2))}")
        print(f"{tag} wall, median of {GRAPH_SOLVES}: batched {1e3 * med:.3f} "
              f"ms ({_ms(walls)}), the {HEAT_B} single device-core solves "
              f"{1e3 * smed:.3f} ms ({_ms(single_walls)}); first batched solve "
              f"(capturing) {1e3 * first[0]:.1f} ms, time_capture "
              f"{1e3 * capture:.1f} ms ({runner.captures} graphs); profiled: "
              f"busy {prof[1]:.3f} ms, idle {prof[2]:.3f}; inside the span "
              f"{span_wall:.3f} ms, busy {span_busy:.3f} ms; busy over the "
              f"unprofiled median {1.0 - prof[1] / 1e3 / med:.3f} idle")
        print(f"{tag} launches over one batched solve {launches}; per replay "
              f"by graph {per_replay}")
        for i, (xs, i1) in enumerate(one):
            check(int(info["safety"][i]) == 1
                  and info["deviation"][i] <= DEVIATION_MAX,
                  f"{tag} item {i}: safety {info['safety'][i]}, deviation "
                  f"{info['deviation'][i]:.3e}")
            check(int(info["steps"][i]) == i1["steps"],
                  f"{tag} item {i}: {info['steps'][i]} steps, its single "
                  f"solve {i1['steps']}")
            if i1["steps"] < k:
                check(true_res[i] < HEAT_TOL, f"{tag} item {i}: true "
                                              f"residual {true_res[i]:.3e}")
            check(x_rel[i] <= 1e-10, f"{tag} item {i}: x {x_rel[i]:.3e} from "
                                     f"its single solve")
        check(torch.equal(X, X2), f"{tag} a second batched solve differs")
        check(launches == expected, f"{tag} launches {launches} are not the "
                                    f"replays' {expected}")
        block = {"amg": "dia_spmm", "cheb8": "cheb_apply_many",
                 "neu4": "neumann_apply_many"}[short]
        check(launches["stencil_spmm"] > 0 and launches[block] > 0,
              f"{tag} the batch did not run #2b and {block}: {launches}")
        single = ("stencil_spmv", "dia_spmv", "cheb_apply", "neumann_apply")
        check(all(launches[nm] == 0 for nm in single),
              f"{tag} a product of the batch ran a single kernel: {launches}")
        check(launches["stencil_spmm_tiled"] == launches["stencil_spmm"],
              f"{tag} #2b ran other than its tiled design")
        if short != "amg":
            check(launches[f"{block}_tiled"] == launches[block],
                  f"{tag} {block} ran other than its tiled design")
        check(any("stencil" in nm for nm in span_names),
              f"{tag} the profiler saw no stencil kernel in the solve's span")
        errs = _check_block_row(tag, s, pre, short,
                                torch.Generator(device=DEVICE).manual_seed(M))
        rows[name] = {"launches": launches, "wall_ms": 1e3 * med,
                      "single_ms": 1e3 * smed, "capture_s": capture,
                      "idle": prof[2], "errs": errs}
    return rows


# the twelfth slice: lkdvRK under the graph core (phases 24-27)
RK_B = 8
RK_BATCH_ROWS = (LKDVRK_ROWS[0], LKDVRK_ROWS[2])
GENERAL = dict(M=100, degree=3)


def _rk_counts(rec, got):
    return (f"{got['steps']} steps, {got['constrained_steps']} constrained "
            f"(record {rec['steps']} / {rec['constrained_steps']})")


def phase_lkdvrk_graph(record, kept):
    """(24) The three M=400 grid rows on the device core, each on the
    system and the RAS + Neumann composite that phase 14 built (``kept``):
    the row through ``time_cgmres(loop="while")``, held to
    ``reference/slice7.json`` as the host-loop row is (certified, CGMRES's
    counts at most the record's, GMRES's within one, deviations within the
    bar); then its CGMRES solve on both loops in this call, medians of 5:
    steps and latch equal, x within 1e-10, a second replayed solve
    bit-equal, the counters the replays' launches, the launches per replay
    of each graph (the composite's 3 products with A and the solve's own
    inside each ``arnoldi`` graph: kernel #1 at (3, 2), the ELL's torch ops
    at (4, 3) and (5, 4)), ``time_capture`` and the idle share of each loop
    under the profiler; the (3, 2) row once more with ``cgs2_fused`` on the
    device core (kernel #5 once per ``arnoldi`` replay).  Returns the
    launches of each path and the walls."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        time_cgmres,
    )

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    paths, walls = {}, {}
    for name in LKDVRK_ROWS:
        s, pre = kept[name]
        rec = record[name]
        cfg = rec["config"]
        tag = f"[{name} graph_core]"
        _reset_launches()
        row = time_cgmres("lkdvrk", k=cfg["k"], tol=cfg["tol"],
                          pre_builder=lambda system: pre, device=DEVICE,
                          loop="while", **cfg["params"])
        torch.cuda.synchronize()
        row_launches = _read_launches()
        devs = max(row["conservation"][f"cgmres_{nm}"]
                   for nm in row["invariant_names"])
        print(f"{tag} time_cgmres(loop='while'): gmres {row['gmres_steps']} "
              f"steps (record {rec['gmres']['steps']}) "
              f"{1e3 * row['time_gmres']:.3f} ms; cgmres "
              f"{_rk_counts(rec['cgmres'], row)}, safety {row['safety']}, "
              f"runtime {1e3 * row['runtime']:.3f} ms (phase 1 "
              f"{1e3 * row['iter_time_unconstrained']:.3f} ms/iteration, "
              f"catch-up {1e3 * row['constraint_building']:.3f} ms, endgame "
              f"{1e3 * row['iter_time_constrained']:.3f} ms/iteration), "
              f"time_capture {row['time_capture']:.3f} s, warm-up pass "
              f"(captures) {row['compile_time']:.3f} s; largest deviation "
              f"{devs:.3e}; launches over the row "
              f"{ {k: v for k, v in row_launches.items() if v} }")
        check(row["safety"] is True, f"{tag} the row's safety "
                                     f"{row['safety']}")
        _check_at_most(tag + " row", row, rec["cgmres"],
                       ("steps", "constrained_steps"))
        check(abs(row["gmres_steps"] - rec["gmres"]["steps"]) <= 1,
              f"{tag} the row's gmres steps {row['gmres_steps']}")
        check(devs <= DEVIATION_MAX, f"{tag} the row's deviation {devs:.3e}")
        cg.clear_core_cache()

        kw = dict(k=cfg["k"], tol=cfg["tol"], pre=pre,
                  constraints=s.constraints())

        def host():
            return cg.cgmres(s.A, s.b, **kw)

        def graphs(timing=False, ortho="cgs2"):
            return cg.cgmres(s.A, s.b, loop="while", timing=timing,
                             ortho=ortho, **kw)

        xg, ig = graphs(timing=True)
        runner = cg.last_core().runner
        before = dict(runner.replayed)
        _reset_launches()
        x2, i2 = graphs()
        torch.cuda.synchronize()
        launches = _read_launches()
        expected = _replayed(runner, before)
        per_replay = runner.launches()
        (xh, ih), host_walls = _timed(host)
        _, graph_walls = _timed(graphs)
        hp, gp = _profiled(host), _profiled(graphs)
        hmed, med = _median(host_walls), _median(graph_walls)
        res = float(torch.linalg.norm(s.b - s.A @ xg))
        dia_a = type(s.A).__name__ == "DIA"
        print(f"{tag} cgmres on the device core: steps {ig['steps']}, "
              f"constrained {ig['constrained_steps']}, safety "
              f"{ig['safety']}, KKT deviation {ig['deviation']:.3e}, true "
              f"residual {res:.4e} (tol {cfg['tol']:.0e}); host loop "
              f"{ih['steps']} / {ih['constrained_steps']} / {ih['safety']}; "
              f"x against the host loop {_rel(xg, xh):.3e}; a second solve "
              f"bit-equal {bool(torch.equal(xg, x2))}")
        print(f"{tag} wall, median of {GRAPH_SOLVES}: host loop "
              f"{1e3 * hmed:.3f} ms ({_ms(host_walls)}), device core "
              f"{1e3 * med:.3f} ms ({_ms(graph_walls)}); time_capture "
              f"{runner.time_capture:.3f} s ({runner.captures} graphs); "
              f"profiled: host loop busy {hp[1]:.3f} ms, idle {hp[2]:.3f}; "
              f"device core busy {gp[1]:.3f} ms, idle {gp[2]:.3f}; busy over "
              f"the unprofiled medians: host loop "
              f"{1.0 - hp[1] / 1e3 / hmed:.3f} idle, device core "
              f"{1.0 - gp[1] / 1e3 / med:.3f} idle")
        print(f"{tag} launches over one solve "
              f"{ {k: v for k, v in launches.items() if v} }; per replay by "
              f"graph {per_replay}")
        for key in ("steps", "constrained_steps", "safety"):
            check(ig[key] == ih[key] == i2[key],
                  f"{tag} {key}: device core {ig[key]}, host loop {ih[key]}")
        check(ig["safety"] is True and ig["deviation"] <= DEVIATION_MAX,
              f"{tag} safety {ig['safety']}, deviation {ig['deviation']:.3e}")
        check(math.isfinite(res) and res < cfg["tol"],
              f"{tag} true residual {res:.3e}")
        check(_rel(xg, xh) <= 1e-10, f"{tag} x {_rel(xg, xh):.3e} from the "
                                     f"host loop")
        check(torch.equal(xg, x2), f"{tag} a second replayed solve differs")
        check(launches == expected, f"{tag} launches {launches} are not the "
                                    f"replays' {expected}")
        nA = (1 + pre.degree) if dia_a else 0
        check(per_replay.get("arnoldi", {}).get("dia_spmv", 0) == nA,
              f"{tag} an arnoldi graph holds {per_replay.get('arnoldi')}, not "
              f"{nA} products with A")
        _check_dia_path(tag, launches, [op for op in (s.A, s.Mmat)
                                        if type(op).__name__ == "DIA"])
        paths[f"{name}_graph_core_row"] = row_launches
        paths[f"{name}_graph_core"] = launches
        walls[name] = {"graph_ms": 1e3 * med, "host_ms": 1e3 * hmed,
                       "capture_s": runner.time_capture, "idle": gp[2],
                       "host_idle": hp[2], "busy_ms": gp[1],
                       "host_busy_ms": hp[1], "steps": ig["steps"]}
        cg.clear_core_cache()
        if name == LKDVRK_ROWS[0]:
            graphs(ortho="cgs2_fused")  # captures
            _reset_launches()
            (xf, jf), fw = _timed(lambda: graphs(ortho="cgs2_fused"), reps=1)
            torch.cuda.synchronize()
            fl = _read_launches()
            print(f"{tag} cgs2_fused on the device core: steps {jf['steps']}"
                  f", safety {jf['safety']}, deviation {jf['deviation']:.3e},"
                  f" wall {1e3 * fw[0]:.3f} ms; x against the host loop "
                  f"{_rel(xf, xh):.3e}; kernel #5 launches "
                  f"{fl['fused_update_matvec']}")
            check(jf["safety"] is True and jf["steps"] == ih["steps"],
                  f"{tag} cgs2_fused: steps {jf['steps']}, safety "
                  f"{jf['safety']}")
            check(_rel(xf, xh) <= 1e-10, f"{tag} cgs2_fused x "
                                         f"{_rel(xf, xh):.3e}")
            check(fl["fused_update_matvec"] == jf["steps"],
                  f"{tag} kernel #5 launched {fl['fused_update_matvec']} "
                  f"times over {jf['steps']} Arnoldi steps")
            paths[f"{name}_graph_core_cgs2_fused"] = fl
            cg.clear_core_cache()
    return paths, walls


def phase_lkdvrk_fused_evolve(record, s0, pre):
    """(25) ``fused_evolve("lkdvrk")`` on the (3, 2) row's evolution of the
    error sweep (M=400, N=10, T=1, k=50, tol=1e-3), the composite built
    once on the row's system ``s0`` (the evolution's operators): the stage
    vector from zeros, as the JAX package's, the state carried in a static
    buffer.  Held to ``lkdvrk_M400_deg3_s2_evolve``: every step certified,
    no KKT fallback, steps at most the record's, the mass and momentum
    drifts within max(1e-10, 10× the record's).  Its energy drift jumps at
    the second step by the first solve's algebraic residual, where
    ``step_update`` re-derives the auxiliary fields: the record's evolution
    starts its first solve from z0 over the stages, this one from zeros,
    as the JAX ``fused_evolve``; so every series is held to the host-loop
    ``evolve`` on the card from the same starts (the first from zeros, a
    step's from the last stage vector after): equal steps, each series
    within 1e-12·i·|e0| at step i, and the step walls side by side.  Then
    the error sweep's evolution, ``run_single`` on ``loop="while"`` against
    ``loop="host"``: its L2 error series within max(1e-6, 10× the record's
    own drift) of the host loop's (PERF.md §2), its steps within one of
    the host loop's (at tol=1e-3 a solve's last residual lies near tol,
    where the rounding of either loop can add a step), and one
    device core built for all its steps, whose captures all come in its
    first steps.  Returns the launches of each path and the walls."""
    import dataclasses
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments import (
        error_sweep,
        wrappers,
    )
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        evolve,
        fused_evolve,
    )

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    rec = record[LKDVRK_EVOLVE]
    cfg = rec["config"]
    (degree, tstages, tol), = cfg["grid"]
    run = rec["runs"][f"CGMRES_{degree}_{tstages}"]
    tag = f"[{LKDVRK_ROWS[0]}_fused_evolve]"
    params = dict(N=cfg["N"], M=cfg["M"], degree=degree, tstages=tstages,
                  T=1.0)
    check(math.isclose(s0.prob.dt, 1.0 / cfg["N"]) and s0.prob.M == cfg["M"],
          f"{tag} the row's system is not the evolution's")

    def fused():
        return fused_evolve("lkdvrk", k=cfg["k"], tol=tol, pre=pre,
                            device=DEVICE, **params)

    # the set-up's launches outside the graphs: the core is built for the
    # first system's constraints, whose stage mapping multiplies z0 by the
    # mass matrix
    _reset_launches()
    s0.constraints()
    torch.cuda.synchronize()
    setup = _read_launches()
    _reset_launches()
    out = fused()
    torch.cuda.synchronize()
    launches = _read_launches()
    t = out["timings"]
    starts, solves = [], []

    def solver(system, x0=None, **kw):  # zeros for the first solve
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        if not solves:
            x0 = torch.zeros_like(system.b)
        solves.append(1)
        return wrappers.cgmres_wrapper(system, x0=x0, **kw)

    host = evolve("lkdvrk", k=cfg["k"], tol=tol, pre=pre, solver=solver,
                  device=DEVICE, **params)
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    host_walls = [b - a for a, b in zip(starts, starts[1:])]
    box = {}
    prof = _profiled(lambda: box.setdefault("out", fused()))[4]
    wall, busy, _ = _window_busy(prof, "fused_evolve steps")
    cap = 1e3 * box["out"]["timings"]["time_capture"]
    e0 = abs(host["energy"][0])
    gaps = {key: max(abs(float(a) - float(b)) / (i + 1) for i, (a, b) in
                     enumerate(zip(out[key], host[key][1:])))
            for key in ("dm", "dmo", "de")}
    print(f"{tag} steps {list(map(int, out['steps']))} (record "
          f"{run['steps']}; host loop from the same starts {host['steps']}),"
          f" safety {list(map(int, out['safety']))}, fallbacks "
          f"{list(map(int, out['fallbacks']))}; dm {list(out['dm'])} (record "
          f"{run['dm'][1:]}); dmo {list(out['dmo'])}; de/|e0| "
          f"{[float(d / e0) for d in out['de']]} (record "
          f"{[d / e0 for d in run['de'][1:]]}); largest gap to the host loop "
          f"per step {gaps}")
    print(f"{tag} step walls {_ms(t['step_wall'])} ms, of them capture "
          f"{_ms(t['step_capture'])} ms; host-loop evolve step walls "
          f"{_ms(host_walls)} ms; profiled warm evolution: wall {wall:.3f} ms,"
          f" capture {cap:.3f} ms, busy {busy:.3f} ms, idle share of the "
          f"wall less capture {1.0 - busy / (wall - cap):.3f}")
    print(f"{tag} launches over the evolution "
          f"{ {k: v for k, v in launches.items() if v} }; per replay by graph "
          f"{t['launches_per_replay']}")
    check(len(out["steps"]) == cfg["N"], f"{tag} ran {len(out['steps'])} steps")
    check(all(int(sf) == 1 for sf in out["safety"]),
          f"{tag} safety {out['safety']}")
    check(not out["fallbacks"].any(), f"{tag} KKT fallbacks")
    check(all(int(a) <= b for a, b in zip(out["steps"], run["steps"])),
          f"{tag} steps {out['steps']} vs record {run['steps']}")
    for key in ("dm", "dmo"):
        check(all(d <= max(1e-10, 10.0 * r)
                  for d, r in zip(out[key], run[key][1:])),
              f"{tag} {key} {out[key]} vs record {run[key]}")
    check(list(map(int, out["steps"])) == host["steps"],
          f"{tag} steps {out['steps']} vs the host loop's {host['steps']}")
    check(all(g <= 1e-12 * e0 for g in gaps.values()),
          f"{tag} drifts off the host loop's: {gaps}")
    check(bool(torch.isfinite(out["sol"]).all())
          and out["sol"].shape == s0.b.shape,
          f"{tag} sol is not a finite stage vector")
    replayed = {nm: t["launches"].get(nm, 0) + setup[nm] for nm in launches}
    check(launches == replayed, f"{tag} launches {launches} are not the "
                                f"replays' and the set-up's {replayed}")
    _check_dia_path(tag, launches, [op for op in (s0.A, s0.Mmat, s0.Gmat)
                                    if type(op).__name__ == "DIA"])
    paths = {f"{LKDVRK_ROWS[0]}_fused_evolve": launches}
    walls = {"fused_step_ms": [1e3 * w for w in t["step_wall"]],
             "fused_capture_ms": [1e3 * w for w in t["step_capture"]],
             "host_step_ms": [1e3 * w for w in host_walls],
             "idle": 1.0 - busy / (wall - cap)}
    cg.clear_core_cache()

    # the error sweep's evolution on both loops
    tag = f"[{LKDVRK_EVOLVE} while]"
    tmpdir = ROOT / "build" / "chip_smoke"
    cores, step_starts = [], []
    solve = wrappers.cgmres_wrapper

    def noted(system, **kw):  # the core of each step, and its start
        torch.cuda.synchronize()
        step_starts.append(time.perf_counter())
        x, info = solve(system, **kw)
        cores.append(cg.last_core())
        return x, info

    args = dict(N=cfg["N"], M=cfg["M"], k=cfg["k"])
    _reset_launches()
    wrappers.cgmres_wrapper = noted
    try:
        dev = error_sweep.run_single("CGMRES", degree, tstages, tol,
                                     tmpdir=str(tmpdir / "while"),
                                     loop="while", device=DEVICE, **args)
    finally:
        wrappers.cgmres_wrapper = solve
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    dev_launches = _read_launches()
    dev_walls = [b - a for a, b in zip(step_starts, step_starts[1:] + [t_end])]
    runner = cores[0].runner
    hst = error_sweep.run_single("CGMRES", degree, tstages, tol,
                                 tmpdir=str(tmpdir / "host2"), device=DEVICE,
                                 **args)

    def rel(a, b):
        return max(abs(x - y) for x, y in zip(a, b)) / max(abs(y) for y in b)

    bar = max(1e-6, 10.0 * run["own_drift"])
    err, err_host = [float(e) for e in dev["err"]], [float(e) for e in hst["err"]]
    print(f"{tag} steps {dev['steps']} (host loop {hst['steps']}, record "
          f"{run['steps']}); step walls {_ms(dev_walls)} ms; one core for "
          f"the evolution {all(c is cores[0] for c in cores)}, "
          f"{runner.captures} graphs captured, replays "
          f"{sum(runner.replayed.values())}; err against the host loop "
          f"{rel(err, err_host):.3e} (bar {bar:.3e}), against the record "
          f"{rel(err, run['err']):.3e}; dm {[float(d) for d in dev['dm']]}")
    check(all(c is cores[0] for c in cores),
          f"{tag} more than one device core for one evolution")
    check(all(abs(a - b) <= 1 for a, b in zip(dev["steps"], hst["steps"])),
          f"{tag} steps {dev['steps']} vs the host loop's {hst['steps']}")
    check(len(err) == len(err_host) and rel(err, err_host) <= bar,
          f"{tag} error series off the host loop's by "
          f"{rel(err, err_host):.3e} (bar {bar:.3e})")
    check(all(d <= 1e-9 for d in dev["dm"]), f"{tag} mass drift {dev['dm']}")
    check(dev_launches["dia_spmv"] > 0, f"{tag} kernel #1 never launched")
    paths[f"{LKDVRK_EVOLVE}_while"] = dev_launches
    walls["sweep_step_ms"] = [1e3 * w for w in dev_walls]
    walls["sweep_captures"] = runner.captures
    cg.clear_core_cache()
    return paths, walls


def phase_lkdvrk_batched(record, kept):
    """(26) ``cgmres_many`` on the (3, 2) and (5, 4) grid rows at B = 8
    with the composite that phase 14 built, item i the row's system
    stepped by ``lkdvrk_stage_states`` (u1 = u0 + 0.02 i·p): every item
    certified, its steps equal to its single device-core solve's and x
    within 1e-10 of it, its true residual below tol; every product of the
    batch with a DIA through #1b and none through #1 (the composite's RAS
    one ``torch.bmm`` of the inverses with the 8 vectors: at (5, 4) 2.6 GB
    read once a block apply); the counters the replays' launches; the
    median wall of 5 batched solves beside the median of 5 rounds of the 8
    single solves, ``time_capture`` and the idle share.  Returns per row its
    launches and walls."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    ref = _reference_script()
    rows = {}
    for name in RK_BATCH_ROWS:
        s, pre = kept[name]
        cfg = record[name]["config"]
        k, tol = cfg["k"], cfg["tol"]
        tag = f"[{name}_B{RK_B}]"
        p = ref.lkdvrk_field(s.fem, s.prob.mlength,
                             s.z0[:s.n0].cpu().numpy())
        states = torch.as_tensor(ref.lkdvrk_stage_states(
            p, RK_B, s.prob.ns, s.n0, s.prob.dt), device=DEVICE)
        items = [s.step_update(z) for z in states]
        Bs = torch.stack([t.b for t in items])
        cons = [t.constraints() for t in items]

        def many():
            return cgmres_many(s.A, Bs, cons, k=k, tol=tol, pre=pre)

        (X, info), first = _timed(many, reps=1)
        runner = cg.last_core().runner
        capture = runner.time_capture
        _, walls = _timed(many)
        before = dict(runner.replayed)
        _reset_launches()
        X2, _ = many()
        torch.cuda.synchronize()
        launches = _read_launches()
        expected = _replayed(runner, before)
        per_replay = runner.launches()
        prof = _profiled(many)
        cg.clear_core_cache()

        def singles():
            return [cg.cgmres(s.A, t.b, k=k, tol=tol, pre=pre,
                              constraints=c, loop="while")
                    for t, c in zip(items, cons)]

        singles()  # the first item's solve captures the graphs
        one, single_walls = _timed(singles)
        cg.clear_core_cache()
        med, smed = _median(walls), _median(single_walls)
        true_res = [float(torch.linalg.norm(t.A @ x - t.b))
                    for t, x in zip(items, X)]
        x_rel = [_rel(X[i], xs) for i, (xs, _) in enumerate(one)]
        print(f"{tag} B={RK_B}, k={k}, tol={tol:.0e}: steps "
              f"{list(map(int, info['steps']))} (single solves "
              f"{[i1['steps'] for _, i1 in one]}), safety "
              f"{list(map(int, info['safety']))}, KKT deviation "
              f"{['%.2e' % d for d in info['deviation']]}, true residual "
              f"{['%.2e' % r for r in true_res]}; x against each single "
              f"solve {['%.2e' % r for r in x_rel]}; a second batched solve "
              f"bit-equal {bool(torch.equal(X, X2))}")
        print(f"{tag} wall, median of {GRAPH_SOLVES}: batched {1e3 * med:.3f} "
              f"ms ({_ms(walls)}), the {RK_B} single device-core solves "
              f"{1e3 * smed:.3f} ms ({_ms(single_walls)}); first batched "
              f"solve (capturing) {1e3 * first[0]:.1f} ms, time_capture "
              f"{1e3 * capture:.1f} ms ({runner.captures} graphs); profiled: "
              f"busy {prof[1]:.3f} ms, idle {prof[2]:.3f}")
        print(f"{tag} launches over one batched solve "
              f"{ {k2: v for k2, v in launches.items() if v} }; per replay "
              f"by graph {per_replay}")
        for i, (_, i1) in enumerate(one):
            check(int(info["safety"][i]) == 1
                  and info["deviation"][i] <= DEVIATION_MAX,
                  f"{tag} item {i}: safety {info['safety'][i]}, deviation "
                  f"{info['deviation'][i]:.3e}")
            check(int(info["steps"][i]) == i1["steps"],
                  f"{tag} item {i}: {info['steps'][i]} steps, its single "
                  f"solve {i1['steps']}")
            check(true_res[i] < tol, f"{tag} item {i}: true residual "
                                     f"{true_res[i]:.3e}")
            check(x_rel[i] <= 1e-10, f"{tag} item {i}: x {x_rel[i]:.3e} from "
                                     f"its single solve")
        check(torch.equal(X, X2), f"{tag} a second batched solve differs")
        check(launches == expected, f"{tag} launches {launches} are not the "
                                    f"replays' {expected}")
        check(launches["dia_spmm"] > 0 and launches["dia_spmv"] == 0,
              f"{tag} the batch's DIA products did not all run #1b: "
              f"{launches}")
        rows[f"{name}_B{RK_B}"] = {
            "launches": launches, "wall_ms": 1e3 * med,
            "single_ms": 1e3 * smed, "capture_s": capture, "idle": prof[2],
            "busy_ms": prof[1]}
    return rows


def phase_lkdv_core_extras():
    """(27) The device core's general constraints and history: CGMRES on
    lkdv M=100, degree 3 (phase 16's system) with the energy as a
    ``GeneralConstraint`` on the device core, whose ``kkt_start`` graph
    holds its Taylor model (the value through kernel #1, the Hessian's
    vmapped products one launch of #1b at width j + 1) and whose
    ``kkt_finish`` graph re-checks the true g; and a ``history=True`` solve
    of the quadratic constraints on the device core.  Each against the host
    loop on the card: steps and latch equal, certified.  This solve runs to
    k at a residual of 5e-4, O(tol) from the solution, so the two loops'
    rounding moves x by more than roundoff (4.6e-6, as phase 3 finds for
    its quadratic solve): the general solve's x is held to the device
    core's quadratic solve within 1e-6 (the bar of
    tests/test_cgmres_lkdv.py::test_general_constraint_matches_quadratic),
    and the history to its own solve: row 0 is r0 (b, from x0 = 0), the
    last row is x, bit for bit, and each row j + 1's true residual is the
    solve's ``res[j]`` within 1e-12 relative.  Returns the launches of
    each."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.constraints import (
        GeneralConstraint,
    )
    from structurepreservingiterativesolvers_torch.models import lkdv

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    s = lkdv.linforms(device=DEVICE, **GENERAL)
    mass, mom, energy_q = s.constraints()

    def energy(x):
        u, _, w = torch.split(x, s.n0)
        return (0.5 * torch.dot(w, s.Mmat @ w) - 0.5 * torch.dot(u, s.Mmat @ u)
                - s.e0)

    gen = GeneralConstraint(func=energy, name="energy")
    kw = dict(k=50, tol=1e-6)
    xq, _ = cg.cgmres(s.A, s.b, constraints=[mass, mom, energy_q],
                      loop="while", **kw)
    cg.clear_core_cache()
    paths = {}
    for label, cons, extra in (("general", [mass, mom, gen], {}),
                               ("history", [mass, mom, energy_q],
                                {"history": True})):
        tag = f"[lkdv hard {label} graph_core]"
        xh, ih = cg.cgmres(s.A, s.b, constraints=cons, **kw, **extra)
        cg.cgmres(s.A, s.b, constraints=cons, loop="while", **kw, **extra)
        runner = cg.last_core().runner
        before = dict(runner.replayed)
        _reset_launches()
        (xd, idv), w = _timed(lambda: cg.cgmres(
            s.A, s.b, constraints=cons, loop="while", **kw, **extra), reps=1)
        launches = _read_launches()
        expected = _replayed(runner, before)
        _, hw = _timed(lambda: cg.cgmres(s.A, s.b, constraints=cons, **kw,
                                         **extra), reps=1)
        dev = _deviations(s, xd)
        print(f"{tag} steps {idv['steps']} (host loop {ih['steps']}), "
              f"constrained {idv['constrained_steps']}, safety "
              f"{idv['safety']}, KKT deviation {idv['deviation']:.3e}; "
              f"deviations {dev}; x against the host loop "
              f"{_rel(xd, xh):.3e}; wall {1e3 * w[0]:.3f} ms against the "
              f"host loop's {1e3 * hw[0]:.3f} ms; time_capture "
              f"{runner.time_capture:.3f} s; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        for key in ("steps", "constrained_steps", "safety"):
            check(idv[key] == ih[key], f"{tag} {key}: device core {idv[key]},"
                                       f" host loop {ih[key]}")
        check(idv["safety"] is True and max(abs(d) for d in dev.values())
              <= DEVIATION_MAX, f"{tag} safety {idv['safety']}, deviations "
                                f"{dev}")
        check(launches == expected, f"{tag} launches {launches} are not the "
                                    f"replays' {expected}")
        check(launches["dia_spmv"] > 0, f"{tag} kernel #1 never launched")
        if label == "general":
            print(f"{tag} x against the device core's quadratic solve "
                  f"{_rel(xd, xq):.3e}")
            check(_rel(xd, xq) <= 1e-6, f"{tag} x {_rel(xd, xq):.3e} from the "
                                        f"quadratic solve")
            check(launches["dia_spmm"] > 0,
                  f"{tag} the Taylor model's Hessian did not run #1b")
        else:
            xs, xsh = idv["x"], ih["x"]
            rows = torch.stack([torch.linalg.norm(s.A @ r - s.b)
                                for r in xs[1:]])
            res = torch.as_tensor(idv["res"], device=DEVICE)
            gap = float(((rows - res).abs() / res).max())
            print(f"{tag} history {tuple(xs.shape)}: rows' true residuals "
                  f"against res {gap:.3e}; against the host loop's history "
                  f"{_rel(xs, xsh):.3e}")
            check(xs.shape == xsh.shape == (idv["steps"] + 1, s.b.shape[0])
                  and torch.equal(xs[0], s.b) and torch.equal(xs[-1], xd)
                  and gap <= 1e-12,
                  f"{tag} history {tuple(xs.shape)}: row 0 r0 "
                  f"{torch.equal(xs[0], s.b)}, last row x "
                  f"{torch.equal(xs[-1], xd)}, residuals off res by {gap:.3e}")
        paths[f"lkdv_hard_{label}_graph_core"] = launches
        cg.clear_core_cache()
    return paths


def _check_path_spmm_any(shapes, path, gen):
    """``_check_path_spmm`` where ``path`` gave the batched kernel any
    operator (a device-core row whose gate opens at its first step has no
    catch-up); returns the largest f64 error, 0 where it gave none."""
    if not shapes.ops.get(path):
        shapes.ops.pop(path, None)
        print(f"[spmm] {path}: no batched launch on this path")
        return 0.0
    return _check_path_spmm(shapes, path, gen)[0]


# the thirteenth slice: heat P2 with the greedy host AMG (phases 28-30)
P2_M, P2_K, P2_TOL, P2_B = 512, 60, 1e-7, 8
P2 = f"heat_P2_M{P2_M}"
P2_N = (2 * P2_M + 1) ** 2
P2_KERNELS = ("dia_spmv", "dia_spmm", "fused_update_matvec")


def _p2_levels(pre):
    """Each level of an AMG hierarchy as (n, format, width): a DIA with its
    diagonal count, an ELL with its row width."""
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA

    return [(L.A.shape[0], "DIA", len(L.A.offsets)) if isinstance(L.A, DIA)
            else (L.A.shape[0], "ELL", L.A.row_width) for L in pre.levels]


def _graph_ms(fn):
    """The device time of ``fn`` captured in a CUDA graph, its replays timed
    by CUDA events back to back (no host gaps): as a step graph of the
    device core runs it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _time_ms(graph.replay, reps=20)


def _top_kernels(prof, count=6):
    """The device's kernels of a profile with the most time: (name, ms)."""
    import torch

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not _is_span(e.key)]
    events.sort(key=lambda e: -e.self_device_time_total)
    return [(e.key[:60], e.self_device_time_total / 1e3)
            for e in events[:count]]


def phase_heat_p2():
    """Phase 28: heat P2 at M=512 (n = 1,050,625; the operator and the
    constraint matrices ELL of width 19), k=60, tol=1e-7 absolute, f64,
    with the default heat pre-builder, which builds the greedy host AMG of
    the system's scipy matrix and places its levels on the card: the
    TimedSolve row through ``time_cgmres`` on both loops (assembly seconds,
    ``time_pre``, ``time_pre_first``, the hierarchy's level sizes and
    formats, steps, constrained steps, latch, residuals and the mass and
    energy deviations of both solvers), each row certified with a gain of
    2 or more over GMRES.  Then, on the device-core row's system and AMG:
    kernel #1 on every level ``from_scipy`` stores as a DIA against its
    plain twin in f64 and f32, and timed there (M=512's levels are all
    ELL: the M=256 anchor, ``phase_heat_p2_dia_anchor``, holds a DIA
    level); the finest level's ELL product on a vector and on a block of
    8, timed; GMRES and CGMRES on both
    loops in this call (medians of 5): the same steps and latch, x within
    1e-10, the KKT deviation, the true residual, the mass and energy
    deviations beside GMRES's, ``time_capture``, the idle share and the
    kernels with the most device time under the profiler, and the
    V-cycle's device busy per apply; #1 launched only on the DIA levels
    (the counters of one solve on each loop, the replays' on the device
    core); then CGMRES with ``ortho="cgs2_fused"`` on both loops, kernel #5
    once per Arnoldi step, x within 1e-10 of the ``cgs2`` solve.  Returns
    the system, the AMG, and the launches, walls and times of the
    report."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        certified_deviations,
        default_pre_builder,
        time_cgmres,
    )
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA, ELL

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    gm = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.gmres")
    paths, walls, rows = {}, {}, {}
    for loop in ("host", "while"):
        tag = f"[{P2} time_cgmres(loop={loop!r})]"
        seen = {"builds": []}

        def pre_builder(system):  # the default, keeping what it was given
            t0 = time.perf_counter()
            seen.setdefault("assembled", t0)
            seen["system"] = system
            seen["pre"] = default_pre_builder("heat")(system)
            torch.cuda.synchronize()
            seen["builds"].append(time.perf_counter() - t0)
            return seen["pre"]

        _reset_launches()
        t0 = time.perf_counter()
        row = time_cgmres("heat", M=P2_M, degree=2, k=P2_K, tol=P2_TOL,
                          pre_builder=pre_builder, device=DEVICE, loop=loop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        s, pre = seen["system"], seen["pre"]
        levels = _p2_levels(pre)
        con = row["conservation"]
        print(f"{tag} assembly {seen['assembled'] - t0:.2f} s; AMG setup "
              f"time_pre_first {row['time_pre_first']:.3f} s, time_pre "
              f"{row['time_pre']:.3f} s; levels (n, format, width) {levels}; "
              f"gmres {row['gmres_steps']} steps {1e3 * row['time_gmres']:.3f}"
              f" ms, residual {row['gmres_res_final']:.3e}; cgmres "
              f"{row['steps']} steps, {row['constrained_steps']} constrained, "
              f"safety {row['safety']}, residual {row['res_final']:.3e}, "
              f"runtime {1e3 * row['runtime']:.3f} ms; deviations cgmres mass "
              f"{con['cgmres_mass']:.3e} energy {con['cgmres_energy']:.3e}, "
              f"gmres mass {con['gmres_mass']:.3e} energy "
              f"{con['gmres_energy']:.3e}; warm-up {row['compile_time']:.3f} "
              f"s; the row {wall:.1f} s; launches over the row "
              f"{ {k: v for k, v in launches.items() if v} }")
        check(isinstance(s.A, ELL) and s.A.row_width == 19
              and isinstance(s.Emat, ELL),
              f"{tag} the operator is not the ELL of width 19")
        check(row["safety"] is True and row["res_final"] < P2_TOL,
              f"{tag} safety {row['safety']}, residual {row['res_final']:.3e}")
        for nm in row["invariant_names"]:
            check(con[f"cgmres_{nm}"] <= DEVIATION_MAX
                  and (con[f"cgmres_{nm}"] < 0.5 * con[f"gmres_{nm}"]
                       or con[f"floor_{nm}"]),
                  f"{tag} {nm}: cgmres {con[f'cgmres_{nm}']:.3e}, gmres "
                  f"{con[f'gmres_{nm}']:.3e}")
        check(launches["dia_spmm"] == 0, f"{tag} #1b ran on a single solve")
        check(launches["dia_spmv"] > 0 or all(f == "ELL" for _, f, _ in levels),
              f"{tag} the DIA levels ran no kernel #1")
        rows[loop] = {
            "assembly_s": seen["assembled"] - t0, "time_pre": row["time_pre"],
            "time_pre_first": row["time_pre_first"],
            "steps": row["steps"], "gmres_steps": row["gmres_steps"],
            "constrained_steps": row["constrained_steps"],
            "runtime_ms": 1e3 * row["runtime"],
            "gmres_ms": 1e3 * row["time_gmres"], "levels": levels}
        paths[f"{P2}_{loop}_row"] = launches
        if loop == "host":
            del s, pre, seen
            cg.clear_core_cache()
    walls["rows"] = rows

    # the DIA levels' products against their plain twins, and timed
    tag = f"[{P2}]"
    gen = torch.Generator(device=DEVICE).manual_seed(28)
    dia_err, dia_times = 0.0, {}
    for lvl, L in enumerate(pre.levels):
        if isinstance(L.A, DIA):
            label = f"{P2}_level{lvl}_A"
            dia_err = max(dia_err, _check_dia(label, L.A, gen))
            x = torch.randn(L.A.shape[0], generator=gen, device=DEVICE,
                            dtype=torch.float64)
            dia_times[label] = _time_dia(L.A, _dia_csr(L.A), x, label)

    # GMRES and CGMRES on both loops, medians of 5
    cons = s.constraints()
    kw = dict(k=P2_K, tol=P2_TOL, pre=pre)
    solves = {
        "gmres_host": lambda: gm.gmres(s.A, s.b, **kw),
        "gmres_while": lambda: gm.gmres(s.A, s.b, loop="while", **kw),
        "cgmres_host": lambda: cg.cgmres(s.A, s.b, constraints=cons, **kw),
        "cgmres_while": lambda: cg.cgmres(s.A, s.b, constraints=cons,
                                          loop="while", **kw),
    }
    got = {}
    for name, fn in solves.items():
        fn()  # the device core captures its graphs here
        runner = cg.last_core().runner if name.endswith("while") else None
        before = dict(runner.replayed) if runner else None
        _reset_launches()
        (x, info), _ = _timed(fn, reps=1)
        launches = _read_launches()
        if runner:
            check(launches == _replayed(runner, before),
                  f"{tag} {name}: launches {launches} are not the replays'")
        _, w = _timed(fn)
        prof = _profiled(fn)
        got[name] = (x, info, launches, w, prof)
        if name == "cgmres_while":
            capture, graphs = runner.time_capture, runner.captures
    for solver in ("gmres", "cgmres"):
        xh, ih, lh, wh, ph = got[f"{solver}_host"]
        xw, iw, lw, ww, pw = got[f"{solver}_while"]
        dev = (certified_deviations(s, xh), certified_deviations(s, xw))
        res = [float(torch.linalg.norm(s.b - s.A @ v)) for v in (xh, xw)]
        keys = ("steps", "constrained_steps", "safety")
        print(f"{tag} {solver}: steps host {ih['steps']} / device core "
              f"{iw['steps']}" + (
                  f", constrained {ih['constrained_steps']} / "
                  f"{iw['constrained_steps']}, safety {ih['safety']} / "
                  f"{iw['safety']}, KKT deviation {ih['deviation']:.3e} / "
                  f"{iw['deviation']:.3e}" if solver == "cgmres" else "")
              + f"; true residual {res[0]:.4e} / {res[1]:.4e}; mass "
              f"deviation {dev[0]['mass']:.3e} / {dev[1]['mass']:.3e}, "
              f"energy {dev[0]['energy']:.3e} / {dev[1]['energy']:.3e}; x "
              f"device core against host loop {_rel(xw, xh):.3e}")
        print(f"{tag} {solver} wall, median of {GRAPH_SOLVES}: host loop "
              f"{1e3 * _median(wh):.3f} ms ({_ms(wh)}), device core "
              f"{1e3 * _median(ww):.3f} ms ({_ms(ww)}); profiled busy host "
              f"loop {ph[1]:.3f} ms (idle {ph[2]:.3f}), device core "
              f"{pw[1]:.3f} ms (idle {pw[2]:.3f}); unprofiled idle: host "
              f"loop {1.0 - ph[1] / 1e3 / _median(wh):.3f}, device core "
              f"{1.0 - pw[1] / 1e3 / _median(ww):.3f}")
        print(f"{tag} {solver} kernels with the most device time, device "
              f"core: {_top_kernels(pw[4])}")
        print(f"{tag} {solver} launches of #1, #1b and #5 over one solve: "
              f"host loop {[lh[k] for k in P2_KERNELS]}, device core "
              f"{[lw[k] for k in P2_KERNELS]}")
        for k_ in keys:
            if k_ in ih:
                check(ih[k_] == iw[k_], f"{tag} {solver} {k_}: host loop "
                                        f"{ih[k_]}, device core {iw[k_]}")
        check(_rel(xw, xh) <= 1e-10, f"{tag} {solver} x {_rel(xw, xh):.3e} "
                                     f"between the loops")
        check(max(res) < P2_TOL, f"{tag} {solver} true residuals {res}")
        for lz in (lh, lw):
            check(lz["dia_spmm"] == 0
                  and (lz["dia_spmv"] > 0 or not dia_times),
                  f"{tag} {solver}: #1 on the DIA levels, none of #1b: {lz}")
        if solver == "cgmres":
            check(iw["safety"] is True and iw["deviation"] <= DEVIATION_MAX,
                  f"{tag} cgmres safety {iw['safety']}, deviation "
                  f"{iw['deviation']:.3e}")
            for nm in ("mass", "energy"):
                check(max(dev[0][nm], dev[1][nm]) <= DEVIATION_MAX,
                      f"{tag} cgmres {nm} deviation {dev}")
        walls[solver] = {"host_ms": 1e3 * _median(wh),
                         "graph_ms": 1e3 * _median(ww),
                         "host_idle": ph[2], "idle": pw[2],
                         "busy_ms": pw[1], "host_busy_ms": ph[1],
                         "steps": iw["steps"]}
        paths[f"{P2}_{solver}_host"] = lh
        paths[f"{P2}_{solver}_graph_core"] = lw
    walls["time_capture"], walls["graphs"] = capture, graphs

    # the V-cycle alone, as the step graphs run it: one apply captured in a
    # CUDA graph, its replays timed by CUDA events (device time, no host
    # gaps); its share of the device core's CGMRES busy; and an eager
    # apply's wall and kernels under the profiler
    v = torch.randn(P2_N, generator=gen, device=DEVICE, dtype=torch.float64)
    vc_ms = _graph_ms(lambda: pre(v))
    vc = _profiled(lambda: pre(v))
    applies = got["cgmres_while"][1]["steps"]
    share = vc_ms * applies / walls["cgmres"]["busy_ms"]
    print(f"{tag} one V-cycle: {vc_ms:.3f} ms of device time as a graph "
          f"replay; eager wall {1e3 * vc[0]:.3f} ms; kernels with the most "
          f"device time {_top_kernels(vc[4])}; {applies} applies are "
          f"{share:.1%} of the device core's CGMRES busy")
    walls["vcycle_ms"], walls["vcycle_share"] = vc_ms, share
    # the finest level's ELL product (torch operations, not a kernel): on a
    # vector, on the (n, 8) view of a (8, n) block (the batched core's and
    # the block V-cycle's operand), and 8 vector products, each a graph
    # replay, beside the bytes it must move (values and columns read once,
    # the vectors read and written once)
    A0 = pre.levels[0].A
    Z = torch.randn(P2_B, P2_N, generator=gen, device=DEVICE,
                    dtype=torch.float64)
    ell = {"vector_ms": _graph_ms(lambda: A0 @ Z[0]),
           "block_ms": _graph_ms(lambda: A0 @ Z.T),
           "vectors_ms": _graph_ms(lambda: [A0 @ z for z in Z])}
    slots = A0.vals.numel() * 16
    ell["bound_vector_ms"] = _bound_ms(slots + 2 * P2_N * 8, 2 * slots / 16)[0]
    ell["bound_block_ms"] = _bound_ms(slots + 2 * P2_B * P2_N * 8,
                                      P2_B * slots / 8)[0]
    print(f"{tag} the finest level's ELL product (n={P2_N}, width "
          f"{A0.row_width}; graph replays): A @ x {ell['vector_ms']:.4f} ms "
          f"(bound {ell['bound_vector_ms']:.4f}), A @ X at B={P2_B} "
          f"{ell['block_ms']:.4f} ms (bound {ell['bound_block_ms']:.4f}), "
          f"{P2_B} products of a vector {ell['vectors_ms']:.4f} ms")
    walls["ell"] = ell

    # CGMRES with the fused CGS2 update on both loops
    x0, i0 = got["cgmres_while"][:2]
    for loop in ("host", "while"):
        _reset_launches()
        x5, i5 = cg.cgmres(s.A, s.b, constraints=cons, loop=loop,
                           ortho="cgs2_fused", **kw)
        torch.cuda.synchronize()
        launches = _read_launches()
        if loop == "while":  # the first solve captured: count a replay
            runner = cg.last_core().runner
            before = dict(runner.replayed)
            _reset_launches()
            x5, i5 = cg.cgmres(s.A, s.b, constraints=cons, loop=loop,
                               ortho="cgs2_fused", **kw)
            torch.cuda.synchronize()
            launches = _read_launches()
            check(launches == _replayed(runner, before),
                  f"{tag} cgs2_fused: launches are not the replays'")
        print(f"[{P2} cgs2_fused {loop}] steps {i5['steps']} (cgs2 "
              f"{i0['steps']}), constrained {i5['constrained_steps']}, safety "
              f"{i5['safety']}, KKT deviation {i5['deviation']:.3e}; x "
              f"against the cgs2 solve {_rel(x5, x0):.3e}; launches of #1, "
              f"#1b and #5 {[launches[k] for k in P2_KERNELS]}")
        check(i5["safety"] is True and i5["steps"] == i0["steps"]
              and i5["deviation"] <= DEVIATION_MAX,
              f"{P2} cgs2_fused {loop}: {i5['steps']} steps, safety "
              f"{i5['safety']}")
        check(_rel(x5, x0) <= 1e-10, f"{P2} cgs2_fused {loop}: x "
                                     f"{_rel(x5, x0):.3e} from cgs2")
        check(launches["fused_update_matvec"] == i5["steps"],
              f"{P2} cgs2_fused {loop}: {launches['fused_update_matvec']} "
              f"launches of #5 over {i5['steps']} steps")
        paths[f"{P2}_cgs2_fused_{loop}"] = launches
    cg.clear_core_cache()
    return s, pre, {"paths": paths, "walls": walls, "dia_err": dia_err,
                    "dia_times": dia_times,
                    "ortho_m": int(i5["steps"]) + 1}


def phase_heat_p2_batched(s, pre, shapes):
    """Phase 29: ``cgmres_many`` on heat P2 M=512 at B = 8
    (``heat_P2_M512_amg_B8``) with the greedy AMG built on the unperturbed
    system, item i ``step_update(z0 + 0.02 i·p)``, p the lowest 3 x 3
    cosine modes at the P2 nodes (``heat_p2_field``, seed 0): every item
    certified, its steps its single device-core solve's and x within 1e-10
    of it; the V-cycle on the block's rows (#1b on the DIA levels, none of
    #1); the counters the replays'; the median wall of 5 beside the median
    of 5 rounds of the 8 single solves, ``time_capture``, the idle share.
    Then #1b on every DIA level at the widths the batch gave it
    (``_check_path_spmm_any``).  Returns the launches, walls and the
    largest #1b error."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    name = f"{P2}_amg_B{P2_B}"
    tag = f"[{name}]"
    ref = _reference_script()
    field = torch.as_tensor(ref.heat_p2_field(s.prob.fem(),
                                              s.z0.cpu().numpy()),
                            device=DEVICE)
    items = [s.step_update(s.z0 + 0.02 * i * field) for i in range(P2_B)]
    Bs = torch.stack([t.b for t in items])
    cons = [t.constraints() for t in items]

    def many():
        return cgmres_many(s.A, Bs, cons, k=P2_K, tol=P2_TOL, pre=pre)

    shapes.path(name, keep=True)
    (X, info), first = _timed(many, reps=1)
    runner = cg.last_core().runner
    capture = runner.time_capture
    _, walls = _timed(many)
    before = dict(runner.replayed)
    _reset_launches()
    X2, info2 = many()
    torch.cuda.synchronize()
    launches = _read_launches()
    expected = _replayed(runner, before)
    prof = _profiled(many)
    shapes.checks()
    cg.clear_core_cache()

    def singles():
        return [cg.cgmres(s.A, t.b, k=P2_K, tol=P2_TOL, pre=pre,
                          constraints=c, loop="while")
                for t, c in zip(items, cons)]

    singles()  # the first item's solve captures the graphs
    one, single_walls = _timed(singles)
    cg.clear_core_cache()
    med, smed = _median(walls), _median(single_walls)
    true_res = [float(torch.linalg.norm(t.A @ x - t.b))
                for t, x in zip(items, X)]
    x_rel = [_rel(X[i], xs) for i, (xs, _) in enumerate(one)]
    has_dia = any(f == "DIA" for _, f, _ in _p2_levels(pre))
    print(f"{tag} B={P2_B}, k={P2_K}: steps {list(map(int, info['steps']))} "
          f"(single solves {[i1['steps'] for _, i1 in one]}), safety "
          f"{list(map(int, info['safety']))}, KKT deviation "
          f"{['%.2e' % d for d in info['deviation']]}, true residual "
          f"{['%.2e' % r for r in true_res]}; x against each single solve "
          f"{['%.2e' % r for r in x_rel]}; a second batched solve bit-equal "
          f"{bool(torch.equal(X, X2))}")
    print(f"{tag} wall, median of {GRAPH_SOLVES}: batched {1e3 * med:.3f} ms "
          f"({_ms(walls)}), the {P2_B} single device-core solves "
          f"{1e3 * smed:.3f} ms ({_ms(single_walls)}); first batched solve "
          f"(capturing) {1e3 * first[0]:.1f} ms, time_capture "
          f"{1e3 * capture:.1f} ms ({runner.captures} graphs); profiled busy "
          f"{prof[1]:.3f} ms, idle {prof[2]:.3f}; unprofiled idle "
          f"{1.0 - prof[1] / 1e3 / med:.3f}; kernels with the most device "
          f"time {_top_kernels(prof[4])}")
    print(f"{tag} launches of #1, #1b and #5 over one batched solve "
          f"{[launches[k] for k in P2_KERNELS]}")
    for i, (xs, i1) in enumerate(one):
        check(int(info["safety"][i]) == 1
              and info["deviation"][i] <= DEVIATION_MAX,
              f"{tag} item {i}: safety {info['safety'][i]}, deviation "
              f"{info['deviation'][i]:.3e}")
        check(int(info["steps"][i]) == i1["steps"],
              f"{tag} item {i}: {info['steps'][i]} steps, its single solve "
              f"{i1['steps']}")
        check(true_res[i] < P2_TOL, f"{tag} item {i}: true residual "
                                    f"{true_res[i]:.3e}")
        check(x_rel[i] <= 1e-10, f"{tag} item {i}: x {x_rel[i]:.3e} from its "
                                 f"single solve")
    check(torch.equal(X, X2), f"{tag} a second batched solve differs")
    check(launches == expected, f"{tag} launches {launches} are not the "
                                f"replays' {expected}")
    check(launches["dia_spmv"] == 0 and (launches["dia_spmm"] > 0
                                         or not has_dia),
          f"{tag} the batch's DIA levels ran other than #1b: {launches}")
    check(launches["fused_update_matvec"] == 0, f"{tag} #5 under a batch")
    err = _check_path_spmm_any(shapes, name, torch.Generator(
        device=DEVICE).manual_seed(29))
    return launches, {"wall_ms": 1e3 * med, "single_ms": 1e3 * smed,
                      "capture_s": capture, "idle": prof[2],
                      "busy_ms": prof[1]}, err


P2_ANCHOR_M = 256  # heat P2 M=256: its third level from_scipy stores as a DIA


def phase_heat_p2_dia_anchor(shapes):
    """The DIA levels of a greedy hierarchy on the card: heat P2 at M=256
    (n = 263,169), whose third level (n = 1,913, 41 diagonals)
    ``from_scipy`` stores as a DIA where every level of M=512's is an ELL.
    Kernel #1 on each DIA level against its plain twin in f64 and f32, and
    timed; one CGMRES solve on each loop (k=60, tol=1e-7) with the
    counters of one solve (#1 five times a V-cycle on each DIA level: two
    sweeps of pre- and post-smoothing and the residual), the device core's
    ``arnoldi`` graph holding them; ``cgmres_many`` at B = 8 (item i
    ``step_update(z0 + 0.02 i·p)``), its V-cycle's DIA levels through #1b
    (five a replay, none of #1), each item certified with its single
    solve's steps; then #1b on those levels at the widths the batch gave
    it (``_check_path_spmm``), and timed at B = 8.  Returns the launches
    by path, the largest f64 errors of #1 and #1b, and the times."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import heat
    from structurepreservingiterativesolvers_torch.ops.sparse import DIA

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    name = f"heat_P2_M{P2_ANCHOR_M}"
    tag = f"[{name}]"
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    t0 = time.perf_counter()
    s = heat.linforms(M=P2_ANCHOR_M, degree=2, device=DEVICE)
    t1 = time.perf_counter()
    pre = default_pre_builder("heat")(s)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    levels = _p2_levels(pre)
    dia_levels = [lvl for lvl, L in enumerate(pre.levels)
                  if isinstance(L.A, DIA)]
    # the DIA levels, for phase 33's f32 checks
    KEEP17["p2_m256_dia"] = [pre.levels[lvl].A for lvl in dia_levels]
    print(f"{tag} assembly {t1 - t0:.2f} s, greedy AMG setup {t2 - t1:.3f} s;"
          f" levels (n, format, width) {levels}")
    check(bool(dia_levels) and all(L.P is not None for L in
                                   (pre.levels[lvl] for lvl in dia_levels)),
          f"{tag} no DIA level above the coarsest: {levels}")
    dia_err, times = 0.0, {}
    for lvl in dia_levels:
        A = pre.levels[lvl].A
        label = f"{name}_level{lvl}_A"
        dia_err = max(dia_err, _check_dia(label, A, gen))
        x = torch.randn(A.shape[0], generator=gen, device=DEVICE,
                        dtype=torch.float64)
        times[label] = _time_dia(A, _dia_csr(A), x, label)
    cons = s.constraints()
    kw = dict(k=P2_K, tol=P2_TOL, pre=pre, constraints=cons)
    paths = {}
    x_host = None
    for loop in ("host", "while"):
        cg.cgmres(s.A, s.b, loop=loop, **kw)  # the device core captures
        runner = cg.last_core().runner if loop == "while" else None
        before = dict(runner.replayed) if runner else None
        _reset_launches()
        x, info = cg.cgmres(s.A, s.b, loop=loop, **kw)
        torch.cuda.synchronize()
        launches = _read_launches()
        per_replay = runner.launches() if runner else None
        print(f"{tag} cgmres {loop}: steps {info['steps']}, constrained "
              f"{info['constrained_steps']}, safety {info['safety']}, KKT "
              f"deviation {info['deviation']:.3e}; launches of #1 "
              f"{launches['dia_spmv']} (live {launches['dia_spmv_live']}, "
              f"dense {launches['dia_spmv_dense']})" + (
                  f"; per arnoldi replay {per_replay.get('arnoldi')}; x against "
                  f"the host loop {_rel(x, x_host):.3e}" if runner else ""))
        check(info["safety"] is True and info["deviation"] <= DEVIATION_MAX,
              f"{tag} cgmres {loop}: safety {info['safety']}")
        check(launches["dia_spmv"] >= 5 * len(dia_levels) * info["steps"]
              and launches["dia_spmm"] == 0,
              f"{tag} cgmres {loop}: {launches['dia_spmv']} launches of #1 "
              f"over {info['steps']} V-cycles")
        if runner:
            check(launches == _replayed(runner, before),
                  f"{tag} launches are not the replays'")
            check(per_replay.get("arnoldi", {}).get("dia_spmv") == 5 * len(dia_levels),
                  f"{tag} an arnoldi graph holds {per_replay.get('arnoldi')}")
            check(_rel(x, x_host) <= 1e-10, f"{tag} x between the loops")
        x_host = x
        paths[f"{name}_{loop}"] = launches
    cg.clear_core_cache()

    ref = _reference_script()
    field = torch.as_tensor(ref.heat_p2_field(s.prob.fem(),
                                              s.z0.cpu().numpy()),
                            device=DEVICE)
    items = [s.step_update(s.z0 + 0.02 * i * field) for i in range(P2_B)]
    Bs = torch.stack([t.b for t in items])
    bcons = [t.constraints() for t in items]
    batch = f"{name}_amg_B{P2_B}"
    shapes.path(batch, keep=True)
    X, binfo = cgmres_many(s.A, Bs, bcons, k=P2_K, tol=P2_TOL, pre=pre)
    runner = cg.last_core().runner
    before = dict(runner.replayed)
    _reset_launches()
    X, binfo = cgmres_many(s.A, Bs, bcons, k=P2_K, tol=P2_TOL, pre=pre)
    torch.cuda.synchronize()
    launches = _read_launches()
    per_replay = runner.launches()
    shapes.checks()
    cg.clear_core_cache()
    singles = [cg.cgmres(s.A, t.b, k=P2_K, tol=P2_TOL, pre=pre,
                         constraints=c, loop="while")
               for t, c in zip(items, bcons)]
    cg.clear_core_cache()
    x_rel = [_rel(X[i], xs) for i, (xs, _) in enumerate(singles)]
    print(f"{tag} cgmres_many B={P2_B}: steps "
          f"{list(map(int, binfo['steps']))} (single solves "
          f"{[i1['steps'] for _, i1 in singles]}), safety "
          f"{list(map(int, binfo['safety']))}; x against each single solve "
          f"{['%.2e' % r for r in x_rel]}; launches of #1b "
          f"{launches['dia_spmm']}, of #1 {launches['dia_spmv']}; per "
          f"arnoldi replay {per_replay.get('arnoldi')}")
    for i, (_, i1) in enumerate(singles):
        check(int(binfo["safety"][i]) == 1
              and int(binfo["steps"][i]) == i1["steps"]
              and x_rel[i] <= 1e-10,
              f"{tag} batched item {i}: steps {binfo['steps'][i]} against "
              f"{i1['steps']}, x {x_rel[i]:.3e}")
    check(launches == _replayed(runner, before),
          f"{tag} batched launches are not the replays'")
    check(launches["dia_spmv"] == 0
          and per_replay.get("arnoldi", {}).get("dia_spmm") == 5 * len(dia_levels),
          f"{tag} the batched V-cycle's DIA levels: {per_replay.get('arnoldi')}")
    paths[batch] = launches
    spmm_err, _ = _check_path_spmm(shapes, batch, gen)
    spmm_times = {f"{label}_B{P2_B}": _time_spmm(
        pre.levels[int(label.split("level")[1].split("_")[0])].A, P2_B,
        f"{label} (batched V-cycle)", gen) for label in times}
    return paths, dia_err, times, spmm_err, spmm_times

def phase_native():
    """Phase 30: the native host kernels (``utils/native.py``, built with
    g++ into ``build/native/``) against scipy on a tridiagonal matrix: the
    CSR product and an ILU(0) solve (no fill: the exact LU)."""
    import numpy as np
    import scipy.sparse as sp

    from structurepreservingiterativesolvers_torch.utils import native

    if not native.available():
        print("[native] no g++ on this machine: the native kernels are not "
              "built, and their users take scipy")
        return
    n = 120
    A = sp.csr_matrix(sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)))
    rng = np.random.default_rng(30)
    x, b = rng.standard_normal(n), rng.standard_normal(n)
    e_mv = float(np.abs(native.csr_spmv(A, x) - A @ x).max())
    e_lu = float(np.abs(A @ native.ILU0(A).solve(b) - b).max())
    print(f"[native] {native.library_path().relative_to(ROOT)}: csr_spmv "
          f"against scipy {e_mv:.2e}, A @ ILU0.solve(b) - b {e_lu:.2e} "
          f"(tridiagonal, n={n})")
    check(e_mv <= 1e-13 and e_lu <= 1e-10, "the native kernels disagree "
                                           "with scipy")


SHARD_SOLVES = 5


def _collectives(prof):
    """The device time (ms) and the count of the NCCL kernels in a
    profile."""
    import torch

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "nccl" in e.key.lower()]
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def _median_walls(fn, reps=SHARD_SOLVES):
    """``fn``'s result and its walls over ``reps`` calls, each ended by a
    device synchronisation."""
    import torch

    walls, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def _med_ms(walls):
    return 1e3 * sorted(walls)[len(walls) // 2]


def phase_sharded():
    """Phase 31: the row-sharded path (``parallel/``) through NCCL, in a
    world of this process (one rank on its card).  Returns the report of
    the windowed kernel and the launches of each sharded path."""
    import numpy as np
    import torch

    from structurepreservingiterativesolvers_torch.experiments import scaling
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.models import heat, swe
    from structurepreservingiterativesolvers_torch.parallel import (
        gather,
        init_distributed,
        make_mesh,
        shard_preconditioner,
        shard_system,
        shard_vector,
    )
    from structurepreservingiterativesolvers_torch.solvers import cgmres
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        clear_core_cache,
    )

    t_phase = time.perf_counter()
    rank, world = init_distributed(device="cuda")
    mesh = make_mesh()
    check(mesh.backend == "nccl", f"[sharded] backend {mesh.backend}")
    print(f"[sharded] mesh: {world} rank(s) of {torch.cuda.device_count()} "
          f"card(s), backend {mesh.backend}, rank {rank} on {mesh.device}")
    s = swe.linforms(M=SWE_M, device=DEVICE)
    A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                  s.constraints(), mesh)
    tag = f"[sharded swe_M{SWE_M}]"
    # the windowed kernel #1 against the unsharded launch and its plain twin
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    x = torch.randn(SWE_N, dtype=torch.float64, device=DEVICE, generator=gen)
    xs = shard_vector(x, mesh)
    ext = A.window(xs)
    _reset_launches()
    y = A.local(ext)
    torch.cuda.synchronize()
    counted = _read_launches()
    check(counted["dia_spmv_window"] == 1 and counted["dia_spmv"] == 1,
          f"{tag} a windowed product counted {counted['dia_spmv_window']} "
          f"windowed of {counted['dia_spmv']} launches")
    y_twin = kd.dia_spmv_window_torch(A.data, A.offsets, A.lo, ext)
    y_full = s.A @ x
    err, rel = _rel_err(y, y_twin)
    bits = bool(torch.equal(gather(y, mesh), y_full))
    X = torch.randn((SWE_N, 8), dtype=torch.float64, device=DEVICE,
                    generator=gen)
    Xs = shard_vector(X, mesh)
    Xext = A.window(Xs.T).T
    Y = A.local(Xext)
    Y_twin = kd.dia_spmm_window_torch(A.data, A.offsets, A.lo, Xext)
    err_b, rel_b = _rel_err(Y, Y_twin)
    bits_b = bool(torch.equal(gather(Y, mesh), s.A @ X))
    print(f"{tag} windowed #1 (window {A.xchg.width} = {A.lo} + "
          f"{A.n_local} + {A.hi}, {'live' if A.live().pays else 'dense'} "
          f"design): max abs error against the plain twin {err:.3e} (rel "
          f"{rel:.3e}), equal to the unsharded launch's bits {bits}; "
          f"windowed #1b (B = 8): {err_b:.3e} (rel {rel_b:.3e}), bits {bits_b}")
    check(rel <= KERNEL_RTOL["float64"] and rel_b <= KERNEL_RTOL["float64"],
          f"{tag} windowed kernel errors {rel:.3e}, {rel_b:.3e}")
    if world == 1:
        check(bits and bits_b, f"{tag} on one rank the windowed products "
                               "must give the unsharded bits")
    nnz = int(torch.count_nonzero(A.data))
    win = {
        "ms": _time_cold_ms(lambda: A.local(ext)),
        "sharded_ms": _time_cold_ms(lambda: A @ xs),
        "exchange_ms": _time_cold_ms(lambda: A.window(xs)),
        "unsharded_ms": _time_cold_ms(lambda: s.A @ x),
        "plain_ms": _time_cold_ms(
            lambda: kd.dia_spmv_window_torch(A.data, A.offsets, A.lo, ext),
            reps=20),
    }
    Acsr = _csr(s.A_csr)
    win["library_ms"] = _time_cold_ms(lambda: Acsr @ x)
    # the local rows' stored non-zeros, the window read once, y written once
    win["bound_ms"], win["bound_by"] = _bound_ms(
        (nnz + A.xchg.width + A.n_local) * 8, 2 * nnz)
    win.update(window=A.xchg.width, n_local=A.n_local, lo=A.lo, hi=A.hi,
               max_abs_err=max(err, err_b), bits=bits and bits_b)
    print(f"{tag} times (f64, L2 flushed): windowed launch {win['ms']:.4f} "
          f"ms (bound {win['bound_ms']:.4f} ms, {win['bound_by']}, at "
          f"{win['bound_ms'] / win['ms']:.1%}), the window's exchange "
          f"{win['exchange_ms']:.4f} ms, sharded A @ x {win['sharded_ms']:.4f} "
          f"ms, unsharded #1 {win['unsharded_ms']:.4f} ms (ratio "
          f"{win['sharded_ms'] / win['unsharded_ms']:.2f}), plain twin "
          f"{win['plain_ms']:.4f} ms, cuSPARSE CSR {win['library_ms']:.4f} ms")
    del X, Xs, Xext, Y, Y_twin, Acsr

    paths, walls, report = {}, {}, {}

    def solve_pair(name, full, sharded, check_x=1e-10, all_windowed=True,
                   **kw):
        """The unsharded and the sharded solve of one configuration on each
        loop: steps, latch and x; walls (median of 5) and the profile of
        one sharded solve; every launch of #1 windowed where
        ``all_windowed`` (else some: the AMG's levels held whole run the
        unwindowed launch)."""
        out = {}
        for loop in ("host", "while"):
            label = f"[sharded {name} {loop}]"
            run_u = lambda: cgmres(*full, loop=loop, **kw)  # noqa: E731
            run_s = lambda: cgmres(*sharded[:3], loop=loop,  # noqa: E731
                                   **{**kw, **sharded[3]})
            run_u()
            run_s()
            (xu, iu), wu = _median_walls(run_u)
            (xsh, ish), wsh = _median_walls(run_s)
            xg = gather(xsh, mesh)
            _reset_launches()
            run_s()
            torch.cuda.synchronize()
            launches = _read_launches()
            prof = _profiled(run_s)
            coll_ms, coll_n = _collectives(prof[4])
            d = _rel(xg, xu)
            print(f"{label} steps {ish['steps']} (unsharded {iu['steps']}), "
                  f"safety {ish.get('safety')} ({iu.get('safety')}), "
                  f"deviation {ish.get('deviation', 0.0):.3e} "
                  f"({iu.get('deviation', 0.0):.3e}), x against the "
                  f"unsharded solve {d:.3e}; wall, median of {SHARD_SOLVES}: "
                  f"sharded {_med_ms(wsh):.3f} ms, unsharded "
                  f"{_med_ms(wu):.3f} ms (ratio "
                  f"{_med_ms(wsh) / _med_ms(wu):.3f}); sharded profiled: "
                  f"busy {prof[1]:.3f} ms, idle {prof[2]:.3f}, collectives "
                  f"{coll_n} NCCL kernels, {coll_ms:.3f} ms; counted per "
                  f"solve: all_reduce {launches['all_reduce']}, all_gather "
                  f"{launches['all_gather']}, all_to_all "
                  f"{launches['all_to_all']}; #1 {launches['dia_spmv']} "
                  f"({launches['dia_spmv_window']} windowed), #1b "
                  f"{launches['dia_spmm']} ({launches['dia_spmm_window']} "
                  f"windowed), #5 {launches['fused_update_matvec']}")
            check(ish["steps"] == iu["steps"], f"{label} steps {ish['steps']} "
                                               f"vs {iu['steps']}")
            check(ish.get("safety") == iu.get("safety"),
                  f"{label} latch {ish.get('safety')} vs {iu.get('safety')}")
            if iu.get("safety") is not None:
                check(ish["deviation"] <= DEVIATION_MAX,
                      f"{label} deviation {ish['deviation']:.3e}")
            check(d <= check_x, f"{label} x {d:.3e} from the unsharded solve")
            check(launches["dia_spmv_window"] > 0 and (
                launches["dia_spmv"] == launches["dia_spmv_window"]
                or not all_windowed),
                  f"{label} #1 launches {launches['dia_spmv']}, windowed "
                  f"{launches['dia_spmv_window']}")
            check(launches["dia_spmm"] == launches["dia_spmm_window"],
                  f"{label} #1b launches {launches['dia_spmm']}, windowed "
                  f"{launches['dia_spmm_window']}")
            check(launches["all_reduce"] > 0,
                  f"{label} no all-reduce counted")
            if kw.get("ortho") == "cgs2_fused":
                check(launches["fused_update_matvec"] == ish["steps"],
                      f"{label} #5 launched {launches['fused_update_matvec']} "
                      f"times over {ish['steps']} steps")
            paths[f"{name}_{loop}"] = launches
            walls[f"{name}_{loop}"] = {
                "sharded_ms": _med_ms(wsh), "unsharded_ms": _med_ms(wu),
                "sharded_walls_ms": [1e3 * w for w in wsh],
                "unsharded_walls_ms": [1e3 * w for w in wu],
                "idle": prof[2], "busy_ms": prof[1],
                "collective_ms": coll_ms, "collective_kernels": coll_n,
                "collectives_counted": {k: launches[k] for k in (
                    "all_reduce", "all_gather", "all_to_all")},
                "steps": ish["steps"]}
            out[loop] = ish
            clear_core_cache()
        return out

    kw = dict(k=SWE_K, tol=SWE_TOL)
    solve_pair(f"swe_M{SWE_M}", (s.A, s.b, None),
               (A, b, x0, {"constraints": cons}), constraints=s.constraints(),
               **kw)
    # the fused CGS2 kernel on the local rows, u2 all-reduced
    label = f"[sharded swe_M{SWE_M} cgs2_fused while]"
    xu, iu = cgmres(s.A, s.b, ortho="cgs2_fused", loop="while",
                    constraints=s.constraints(), **kw)
    _reset_launches()
    xsh, ish = cgmres(A, b, x0, ortho="cgs2_fused", loop="while",
                      constraints=cons, **kw)
    torch.cuda.synchronize()
    launches = _read_launches()
    d = _rel(gather(xsh, mesh), xu)
    print(f"{label} steps {ish['steps']} ({iu['steps']}), safety "
          f"{ish['safety']}, x {d:.3e}; #5 {launches['fused_update_matvec']}, "
          f"#1 windowed {launches['dia_spmv_window']}, all_reduce "
          f"{launches['all_reduce']}")
    check(ish["steps"] == iu["steps"] and ish["safety"] is True and d <= 1e-10,
          f"{label} steps {ish['steps']} vs {iu['steps']}, x {d:.3e}")
    check(launches["fused_update_matvec"] == ish["steps"],
          f"{label} #5 launched {launches['fused_update_matvec']} times")
    paths[f"swe_M{SWE_M}_cgs2_fused_while"] = launches
    clear_core_cache()
    # the skew-normal Chebyshev, as chained sharded products
    pre = default_pre_builder("swe")(s)
    solve_pair(f"swe_M{SWE_M}_snc", (s.A, s.b, None),
               (A, b, x0, {"constraints": cons,
                           "pre": shard_preconditioner(pre, mesh)}),
               constraints=s.constraints(), pre=pre, k=SNC_K, tol=SNC_TOL)
    del pre, A, b, x0, cons, x, xs, ext
    torch.cuda.empty_cache()
    # heat M=1024 with the AMG, its levels of 32,768 rows or more sharded
    t0 = time.perf_counter()
    h = heat.linforms(M=HEAT_M, device=DEVICE)
    hpre = default_pre_builder("heat")(h)
    hA, hb, hx0, hcons = shard_system(h.A, h.b, torch.zeros_like(h.b),
                                      h.constraints(), mesh)
    hpre_sh = shard_preconditioner(hpre, mesh)
    print(f"[sharded heat_M{HEAT_M}] assembly and AMG "
          f"{time.perf_counter() - t0:.2f} s; levels (rows, sharded): "
          + ", ".join(f"({L.A.shape[0]}, {type(L.A).__name__ != 'DIA'})"
                      for L in hpre_sh.levels))
    solve_pair(f"heat_M{HEAT_M}_amg", (h.A, h.b, None),
               (hA, hb, hx0, {"constraints": hcons, "pre": hpre_sh}),
               check_x=1e-8, all_windowed=False, constraints=h.constraints(),
               pre=hpre,
               k=HEAT_K, tol=HEAT_TOL)
    del h, hpre, hA, hb, hx0, hcons, hpre_sh
    torch.cuda.empty_cache()
    # three fused_evolve steps, sharded and not, with the skew-normal
    # Chebyshev built on the first system
    params = dict(M=SWE_M, N=3, T=0.3)
    s3 = swe.linforms(device=DEVICE, **params)
    pre3 = default_pre_builder("swe")(s3)
    runs = {}
    for key, m in (("unsharded", None), ("sharded", mesh)):
        fused_evolve("swe", k=SNC_K, tol=SNC_TOL, pre=pre3, mesh=m,
                     device=DEVICE, **params)
        _reset_launches()
        runs[key] = fused_evolve("swe", k=SNC_K, tol=SNC_TOL, pre=pre3, mesh=m,
                                 device=DEVICE, **params)
        torch.cuda.synchronize()
        # the steps' walls (a step's start to the next's, the last to the
        # fetch), captures left out: the system's assembly is set-up
        t = runs[key]["timings"]
        runs[key]["step_ms"] = [float(1e3 * (w - c)) for w, c in
                                zip(t["step_wall"], t["step_capture"])]
    fu, fs = runs["unsharded"], runs["sharded"]
    d = _rel(fs["sol"], fu["sol"])
    label = f"[sharded swe_M{SWE_M}_fused_evolve]"
    print(f"{label} steps {fs['steps'].tolist()} (unsharded "
          f"{fu['steps'].tolist()}), safety {fs['safety'].tolist()}, de "
          f"{fs['de'].tolist()} (unsharded {fu['de'].tolist()}), sol against "
          f"the unsharded {d:.3e}; step walls, captures left out: sharded "
          f"{[round(w, 3) for w in fs['step_ms']]} ms, unsharded "
          f"{[round(w, 3) for w in fu['step_ms']]} ms; launches "
          f"{fs['timings']['launches']}")
    check(list(fs["steps"]) == list(fu["steps"]), f"{label} steps")
    check(all(v == 1 for v in fs["safety"]), f"{label} safety {fs['safety']}")
    check(d <= 1e-10, f"{label} sol {d:.3e} from the unsharded evolution")
    check(float(np.max(np.abs(fs["de"] - fu["de"]))) <= 1e-8,
          f"{label} energy drifts {fs['de']} vs {fu['de']}")
    paths[f"swe_M{SWE_M}_fused_evolve"] = fs["timings"]["launches"]
    walls["fused_evolve"] = {"sharded_step_ms": fs["step_ms"],
                             "unsharded_step_ms": fu["step_ms"]}
    del s3, pre3, runs, fu, fs
    clear_core_cache()
    torch.cuda.empty_cache()
    # the scaling rows at one device
    sp = scaling.spmv_scaling("swe", M=SWE_M, device_counts=[1], device="cuda")
    so = scaling.solve_scaling("swe", M=SWE_M, k=SWE_K, tol=SWE_TOL,
                               device_counts=[1], device="cuda")
    print("[sharded scaling] spmv_scaling\n" + scaling.report(sp))
    print("[sharded scaling] solve_scaling\n" + scaling.report(so))
    check(len(sp) == len(so) == 1 and sp[0]["devices"] == 1,
          "[sharded scaling] rows")
    report["scaling"] = {"spmv": sp, "solve": so}
    if torch.cuda.device_count() >= 2:
        rows = scaling.dist_efficiency("swe", M=SWE_M, k=SWE_K, tol=SWE_TOL,
                                       process_counts=(1, 2), device="cuda")
        check(rows[0]["steps"] == rows[1]["steps"]
              and rows[1]["safety"] is True,
              f"[sharded dist-bench] {rows}")
        report["dist_bench"] = rows
    report.update(walls=walls, window=win)
    print("[sharded] " + json.dumps(report))
    print(f"[sharded] phase took {time.perf_counter() - t_phase:.1f} s")
    return win, paths, _sharded_f32(mesh)


# the fifteenth slice: f32 storage (phase 32).  The chip rows' tolerances
# (rhs-relative: tol·||b||, as the JAX package's f32 TimedSolve rows take
# them; heat's absolute row beside), k, and the bars: a certified deviation
# within max(10x the JAX f32 record's, F32_DEV_SCALE of the invariant's
# scale), steps within F32_STEPS of the record's, the mixed #1 within
# F32_MIXED_RTOL of its plain version, and CGS2's f32 products within
# F32_PRODUCT_BAR of an f64 product relative to |Q| |w| (an f32 sum errs
# ~1e-6 there, a TF32 product ~1e-3)
F32_SWE_RTOL, F32_HEAT_RTOL, F32_HEAT_ABS, F32_K = 4e-7, 1e-6, 1e-7, 20
F32_DEV_SCALE, F32_STEPS, F32_MIXED_RTOL = 1e-10, 2, 1e-14
F32_PRODUCT_BAR = 1e-5
F32_SOLVES = 3
# NVIDIA H100 SXM data sheet: the f32 rate outside the tensor cores
F32_FLOP_PER_S = 67e12
# the kernels whose f32 instantiations have a counter of their own
F32_KERNELS = ("dia_spmv", "dia_spmm", "stencil_spmv", "stencil_spmm",
               "cheb_apply", "neumann_apply", "fused_update_matvec")


def _bound32_ms(nbytes, nflop):
    """``_bound_ms`` for f32 work: bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nflop / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _csr_dtype(A_csr, dtype):
    """``_csr`` in ``dtype``: cuSPARSE's operand at the kernel's precision."""
    import torch

    A = _csr(A_csr)
    return torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(),
                                   A.values().to(dtype), size=A.shape,
                                   device=DEVICE)


def _f32_time(label, fn, plain, nbytes, nflop, library=None, note=""):
    """An f32 kernel at a path's shape with L2 flushed, beside its plain
    version, its f32 bound and, where there is one, the library call."""
    t = {"ms": _time_cold_ms(fn), "plain_ms": _time_cold_ms(plain, reps=10),
         "library_ms": None if library is None else _time_cold_ms(library)}
    t["bound_ms"], t["bound_by"] = _bound32_ms(nbytes, nflop)
    lib = ("none" if library is None
           else f"{t['library_ms']:.4f} ms{note}")
    print(f"[f32] {label}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f}"
          f" ms ({t['bound_by']}, {nbytes / 1e6:.1f} MB; kernel at "
          f"{t['bound_ms'] / t['ms']:.1%} of it), plain {t['plain_ms']:.4f} "
          f"ms, library {lib}")
    return t


def _f32_kernels(swe32, heat32):
    """The f32 instantiations at their f32 paths' shapes: the mixed #1
    checked on swe M=512's A and heat M=1024's energy matrix (``Emat``)
    against its plain version, then #1 (swe A live, heat A's DIA dense),
    the mixed #1, #1b (swe A, B = 8), #2 and #2b (heat, B = 8) and #5 (m =
    21 at swe's n) timed (``_f32_time``), and CGS2's f32 cuBLAS products
    held to an f32 (not TF32) error bound against an f64 product.  Returns
    the times by label and the mixed #1's largest absolute error."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.kernels import ortho
    from structurepreservingiterativesolvers_torch.kernels import (
        stencil_spmv as ks,
    )
    from structurepreservingiterativesolvers_torch.ops.sparse import matvec_f64

    gen = torch.Generator(device=DEVICE).manual_seed(32)
    f32 = torch.float32
    mixed_err, times = 0.0, {}
    A, E, S = swe32.A, heat32.Emat, heat32.A
    for label, M in ((f"swe M={SWE_M} A", A), (f"heat M={HEAT_M} Emat", E)):
        x = torch.randn(M.shape[0], generator=gen, device=DEVICE, dtype=f32)
        before = kd.dia_spmv_mixed_cuda.launches
        y = matvec_f64(M, x)
        again = matvec_f64(M, x)
        torch.cuda.synchronize()
        ref = kd.dia_spmv_mixed_torch(M.data, M.offsets, M.wrap, x)
        abs_err, rel = _rel_err(y, ref)
        check(y.dtype == torch.float64
              and kd.dia_spmv_mixed_cuda.launches == before + 2,
              f"mixed #1 {label}: not the mixed launch ({y.dtype})")
        print(f"[f32] mixed #1 (f32 in, f64 out) on {label} ({M.live().share:.4f} "
              f"live, {'live' if M.live().pays else 'dense'} design): "
              f"max|dy|/max|y| = {rel:.3e} against the upcast f64 product "
              f"(bound {F32_MIXED_RTOL:.0e}), a second launch equal "
              f"{torch.equal(y, again)}")
        check(math.isfinite(rel) and rel <= F32_MIXED_RTOL
              and torch.equal(y, again),
              f"mixed #1 disagrees with its plain version on {label}: {rel:.3e}")
        mixed_err = max(mixed_err, abs_err)
        nnz = int(torch.count_nonzero(M.data))
        n = M.shape[0]
        csr64 = _csr_dtype(swe32.A_csr if M is A else _dia_csr(M),
                           torch.float64)
        x64 = x.double()
        times[f"mixed_{label}"] = _f32_time(
            f"mixed #1 {label}", lambda: matvec_f64(M, x),
            lambda: kd.dia_spmv_mixed_torch(M.data, M.offsets, M.wrap, x),
            4 * nnz + 4 * n + 8 * n, 2 * nnz, lambda: csr64 @ x64,
            " (cuSPARSE f64 CSR on the upcast x, the upcast not timed)")
    for label, M, A_csr in ((f"swe M={SWE_M} A", A, swe32.A_csr),
                            (f"heat M={HEAT_M} A (DIA)", S.dia,
                             heat32.A_csr)):
        x = torch.randn(M.shape[0], generator=gen, device=DEVICE, dtype=f32)
        nnz, n = int(torch.count_nonzero(M.data)), M.shape[0]
        csr = _csr_dtype(A_csr, f32)
        times[f"dia_spmv_{label}"] = _f32_time(
            f"#1 {label} ({'live' if M.live().pays else 'dense'})",
            lambda: M @ x,
            lambda: kd.dia_spmv_torch(M.data, M.offsets, M.wrap, x),
            4 * (nnz + 2 * n), 2 * nnz, lambda: csr @ x,
            " (cuSPARSE f32 CSR)")
    n, B = A.shape[0], 8
    X = torch.randn(B, n, generator=gen, device=DEVICE, dtype=f32).T
    Xc, csr = X.contiguous(), _csr_dtype(swe32.A_csr, f32)
    nnz = int(torch.count_nonzero(A.data))
    times[f"dia_spmm_swe M={SWE_M} A B=8"] = _f32_time(
        f"#1b swe M={SWE_M} A, B = 8", lambda: A @ X,
        lambda: kd.dia_spmm_torch(A.data, A.offsets, A.wrap, X),
        4 * (nnz + 2 * B * n), 2 * nnz * B,
        lambda: torch.sparse.mm(csr, Xc), " (cuSPARSE f32 SpMM)")
    n = S.shape[0]
    x = torch.randn(n, generator=gen, device=DEVICE, dtype=f32)
    csr = _csr_dtype(heat32.A_csr, f32)
    S @ x
    plain = (S.const, S.offsets, S.wrap, S.grid_c, S.strips)
    times[f"stencil_spmv_heat M={HEAT_M}"] = _f32_time(
        f"#2 heat M={HEAT_M} ({S._launch.design} design)", lambda: S @ x,
        lambda: ks.stencil_spmv_torch(*plain, x),
        4 * 2 * n, 2 * 7 * n, lambda: csr @ x, " (cuSPARSE f32 CSR)")
    X = _heat_block(n, B, gen, f32)
    Xc = X.contiguous()
    times[f"stencil_spmm_heat M={HEAT_M} B=8"] = _f32_time(
        f"#2b heat M={HEAT_M}, B = 8", lambda: S @ X,
        lambda: ks.stencil_spmm_torch(*plain, X),
        4 * 2 * B * n, 2 * 7 * n * B, lambda: torch.sparse.mm(csr, Xc),
        " (cuSPARSE f32 SpMM)")
    m, n = 21, A.shape[0]
    Q = torch.randn(m, n, generator=gen, device=DEVICE, dtype=f32)
    w = torch.randn(n, generator=gen, device=DEVICE, dtype=f32)
    h = Q @ w
    times[f"fused_update_matvec_swe M={SWE_M} m=21"] = _f32_time(
        f"#5 swe M={SWE_M}, m = 21", lambda: ortho.fused_update_matvec(Q, w, h),
        lambda: ortho.fused_update_matvec_torch(Q, w, h),
        4 * (m * n + 2 * n), 4 * m * n)
    # CGS2's f32 products through cuBLAS: f32 sums, not TF32
    h64 = Q.double() @ w.double()
    scale = Q.double().abs() @ w.double().abs()
    err_h = float(((h.double() - h64).abs() / scale).max())
    y32 = h @ Q
    y64 = h.double() @ Q.double()
    err_y = float(((y32.double() - y64).abs()
                   / (h.double().abs() @ Q.double().abs())).max())
    print(f"[f32] CGS2 products in f32 (cuBLAS, allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}): Q @ w max|dh|/(|Q||w|) "
          f"{err_h:.3e}, h @ Q {err_y:.3e} against f64 (bar "
          f"{F32_PRODUCT_BAR:.0e}; a TF32 product errs ~1e-3)")
    check(not torch.backends.cuda.matmul.allow_tf32
          and max(err_h, err_y) <= F32_PRODUCT_BAR,
          f"CGS2's f32 products are not f32-accurate: {err_h:.3e}, {err_y:.3e}")
    return times, mixed_err


def _f32_launch_gate(tag, launches, dtype):
    """An f32 row launched the f32 instantiation of every kernel it ran (and
    at least one); an f64 row none."""
    import torch

    ran = {k: launches[k] for k in F32_KERNELS if launches[k]}
    f32 = {k: launches[f"{k}_f32"] for k in F32_KERNELS}
    if dtype == torch.float32:
        check(ran and all(f32[k] == n for k, n in ran.items()),
              f"{tag} not every launch ran the f32 instantiation: {ran}, "
              f"f32 {f32}")
    else:
        check(not any(f32.values()) and launches["dia_spmv_mixed"] == 0,
              f"{tag} an f64 row launched f32 kernels: {f32}")
    print(f"{tag} launches {ran}; of them f32 "
          f"{ {k: f32[k] for k in ran} }; mixed #1 {launches['dia_spmv_mixed']}")


def _f32_record_gate(tag, out, rec):
    """A TimedSolve row's CGMRES against the JAX f32 record of its size: the
    latch equal, steps within ``F32_STEPS`` (or fewer where the row
    certified below tol: where the f32 reduction's constrained residual
    sits at the tolerance, as on swe M=512, whether a step lands below it
    is a matter of f32 rounding), the certified deviation within max(10x
    the record's, ``F32_DEV_SCALE`` of the invariant's scale), and the true
    residual below tol where the record's is."""
    con = out["conservation"]
    dev = max(con[f"cgmres_{nm}"] for nm in out["invariant_names"])
    rec_c = rec["cgmres"]
    rec_dev = max(rec_c["certified"].values())
    scale = max([abs(v) for v in rec["targets"].values()] + [1.0])
    bar = max(10.0 * rec_dev, F32_DEV_SCALE * scale)
    print(f"{tag} against the JAX f32 record: steps {out['steps']} (record "
          f"{rec_c['steps']}), safety {out['safety']} ({rec_c['safety']}), "
          f"certified deviation {dev:.3e} (record {rec_dev:.3e}, bar "
          f"{bar:.3e}), residual {out['res_final']:.4e} (record "
          f"{rec_c['true_residual']:.4e}, tol {out['tol_effective']:.4e})")
    check(out["safety"] == rec_c["safety"],
          f"{tag} safety {out['safety']} vs record {rec_c['safety']}")
    early = (out["steps"] < rec_c["steps"] and out["safety"] is True
             and out["res_final"] < out["tol_effective"])
    check(abs(out["steps"] - rec_c["steps"]) <= F32_STEPS or early,
          f"{tag} steps {out['steps']} vs record {rec_c['steps']}")
    check(dev <= bar, f"{tag} certified deviation {dev:.3e} above {bar:.3e}")
    if rec_c["true_residual"] < rec["tol_abs"]:
        check(out["res_final"] < out["tol_effective"],
              f"{tag} true residual {out['res_final']:.3e} not below tol")


def _f32_timed_rows(record):
    """The TimedSolve rows in f32 and their f64 twins, through
    ``time_cgmres(dtype=...)``: swe M=512 with the skew-normal Chebyshev
    (tol 4e-7·||b||) on both loops with ``cgs2`` and ``cgs2_fused``, heat
    M=1024 with the AMG (tol 1e-6·||b||) on both loops and at tol 1e-7
    absolute on the device core.  Each f32 row is held to the JAX f32
    record of its size and launches only f32 instantiations (the mixed #1
    on heat, whose energy matrix is a DIA); each f64 twin none.  Then one
    CGMRES solve of each f32 device-core row profiled beside its twin (busy,
    idle) and the projection's graph replayed alone (CUDA events).
    Returns the rows by name and their launches."""
    import importlib

    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
        time_cgmres,
    )

    cg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    specs = []
    for loop in ("host", "while"):
        for ortho in ("cgs2", "cgs2_fused"):
            specs.append((f"swe_M{SWE_M}_snc_{loop}_{ortho}", "swe", SWE_M,
                          F32_SWE_RTOL, "rhs", loop, ortho,
                          f"swe_M{SWE_M}_snc_f32"))
        specs.append((f"heat_M{HEAT_M}_amg_{loop}", "heat", HEAT_M,
                      F32_HEAT_RTOL, "rhs", loop, "cgs2",
                      f"heat_M{HEAT_M}_amg_f32"))
    specs.append((f"heat_M{HEAT_M}_amg_abs_while", "heat", HEAT_M,
                  F32_HEAT_ABS, "abs", "while", "cgs2",
                  f"heat_M{HEAT_M}_amg_abs_f32"))
    rows, launches, profiles = {}, {}, {}
    for name, problem, M, tol, mode, loop, ortho, rec_name in specs:
        for dtype in (torch.float32, torch.float64):
            key = f"{name}_{str(dtype)[6:]}"
            tag = f"[f32 {key}]"
            seen = {}

            def pre_builder(system, problem=problem, seen=seen):
                seen["system"] = system
                seen["pre"] = default_pre_builder(problem)(system)
                return seen["pre"]

            _reset_launches()
            t0 = time.perf_counter()
            out = time_cgmres(problem, M=M, k=F32_K, tol=tol, tol_mode=mode,
                              pre_builder=pre_builder, device=DEVICE,
                              loop=loop, ortho=ortho, dtype=dtype)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[key] = _read_launches()
            con = out["conservation"]
            print(f"{tag} time_cgmres wall {wall:.2f} s; gmres {out['gmres_steps']}"
                  f" steps {1e3 * out['time_gmres']:.3f} ms; cgmres "
                  f"{out['steps']} steps ({out['constrained_steps']} "
                  f"constrained) {1e3 * out['runtime']:.3f} ms, safety "
                  f"{out['safety']}, snap {1e3 * out.get('time_snap', 0.0):.3f}"
                  f" ms, residual {out['res_final']:.4e} (tol "
                  f"{out['tol_effective']:.4e}); certified deviations "
                  + ", ".join(f"{nm} gmres {con[f'gmres_{nm}']:.3e} cgmres "
                              f"{con[f'cgmres_{nm}']:.3e}"
                              for nm in out["invariant_names"]))
            _f32_launch_gate(tag, launches[key], dtype)
            if dtype == torch.float32:
                if rec_name in record:
                    _f32_record_gate(tag, out, record[rec_name])
                if problem == "heat":
                    check(launches[key]["dia_spmv_mixed"] > 0,
                          f"{tag} the certificates did not run the mixed #1")
            else:
                check(out["safety"] is True, f"{tag} f64 twin not certified")
            rows[key] = {k: out[k] for k in (
                "steps", "gmres_steps", "constrained_steps", "safety",
                "runtime", "time_gmres", "res_final", "tol_effective",
                "constraint_building", "iter_time_unconstrained",
                "iter_time_constrained")}
            rows[key]["time_snap"] = out.get("time_snap", 0.0)
            rows[key]["deviations"] = {nm: con[f"cgmres_{nm}"]
                                       for nm in out["invariant_names"]}
            rows[key]["gmres_deviations"] = {nm: con[f"gmres_{nm}"]
                                             for nm in out["invariant_names"]}
            if loop == "while" and ortho == "cgs2" and mode == "rhs":
                s, pre = seen["system"], seen["pre"]

                def solve(s=s, pre=pre, tol=out["tol_effective"]):
                    return wrappers.cgmres_wrapper(s, k=F32_K, tol=tol,
                                                   pre=pre, loop="while")

                wall_p, busy, idle, _, _ = _profiled(solve)
                core = cg.last_core()
                snap_ms = None
                if "snap" in core.runner.graphs:
                    graph = core.runner.graphs["snap"][0]
                    snap_ms = _time_ms(graph.replay, reps=10)
                profiles[key] = {"wall_ms": 1e3 * wall_p, "busy_ms": busy,
                                 "idle": idle, "snap_graph_ms": snap_ms}
                print(f"{tag} one profiled CGMRES solve on the device core: "
                      f"wall {1e3 * wall_p:.3f} ms, busy {busy:.3f} ms, idle "
                      f"{idle:.3f}; the projection's graph alone "
                      + ("none" if snap_ms is None else f"{snap_ms:.3f} ms"))
                del s, pre, seen
            torch.cuda.empty_cache()
    return rows, launches, profiles


def _swe_certificate(system, x):
    """swe's deviations (mass, energy) at the f32 iterate x, in f64 on the
    card from the system's fields (g = ω·x − m0, ½ x·(L x) − e0), each
    beside the floor of the projection's certificate: the largest of
    the solver's ``CTOL``, 32·eps64 times the sum of g's terms' magnitudes
    and 16·eps32·max_i |x_i ∂g/∂x_i| (``constraints/projection.py::
    certified_floor``, computed here from its definition)."""
    import torch

    from structurepreservingiterativesolvers_torch.config import CTOL

    xd = x.double()
    om = system.omega.double()
    lx = system.Lfull.matvec_f64(x)
    out = []
    for terms, grad in (((om @ xd, -system.m0.double()), om),
                        ((0.5 * (xd @ lx), -system.e0.double()), lx)):
        g = float(terms[0] + terms[1])
        floor = max(CTOL, 32 * torch.finfo(torch.float64).eps
                    * sum(abs(float(t)) for t in terms),
                    16 * torch.finfo(torch.float32).eps
                    * float((xd * grad).abs().max()))
        out.append((abs(g), floor))
    return out


def _f32_fused(record):
    """A 3-step ``fused_evolve`` on swe M=512 in f32 and its f64 twin, T=0.3,
    the skew-normal Chebyshev built once, tol 4e-7·||b|| of the first
    system: per step the steps, the latch, the drifts, the step walls and
    the launches (the projection inside the core's solve, one graph a
    step).  The f64 twin certifies every step; the f32 run certifies every
    step too, each warm-started, in at most one step more than the JAX f32
    record's per step, and so does the f32 host-loop ``evolve`` of the same
    row, warm-started, each of its steps' mass and energy deviations at the
    returned iterate within the certificate's floor (``_swe_certificate``).
    The JAX f32 record trips the latch on every step: its targets are the
    previous f32 state's invariants summed in f32, and its endgame's floors
    are eps64's from a warm start, where an f32 Krylov basis carries swe's
    mass to eps32 only.  The port sums the targets in f64
    (``constraints/quadratic.py::target_dot``), takes every floor of a warm
    start's endgame at eps32 over f32 storage and lets the projection's f64
    certificate at the returned iterate set the latch
    (``solvers/cgmres.py::floor_eps``).  The drifts of an f32 run are of
    its f32 invariants (``compute_invariants``), to f32 roundoff."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        evolve,
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.models import swe
    from structurepreservingiterativesolvers_torch.precond import (
        skew_normal_chebyshev,
    )

    out = {}
    for dtype in (torch.float32, torch.float64):
        key = f"swe_M{SWE_M}_fused_evolve_{str(dtype)[6:]}"
        tag = f"[f32 {key}]"
        s0 = swe.linforms(M=SWE_M, N=EVOLVE_N, T=EVOLVE_T, device=DEVICE,
                          dtype=dtype)
        pre = skew_normal_chebyshev(s0.A, a=1.0 / s0.prob.dt)
        tol = F32_SWE_RTOL * float(torch.linalg.norm(s0.b.double()))
        del s0
        _reset_launches()
        run = fused_evolve("swe", N=EVOLVE_N, M=SWE_M, k=F32_K, tol=tol,
                           T=EVOLVE_T, pre=pre, device=DEVICE, dtype=dtype)
        torch.cuda.synchronize()
        launches = _read_launches()
        walls = run["timings"]["step_wall"]
        print(f"{tag} steps {run['steps'].tolist()}, safety "
              f"{run['safety'].tolist()}, fallbacks {run['fallbacks'].tolist()},"
              f" dm {run['dm'].tolist()}, de {run['de'].tolist()}; step walls "
              f"{_ms(walls)} ms (capture {run['timings']['time_capture']:.3f} "
              f"s); per replay {run['timings']['launches_per_replay']}")
        _f32_launch_gate(tag, launches, dtype)
        check(bool(torch.isfinite(run["sol"]).all()), f"{tag} not finite")
        rec = record.get(f"swe_M{SWE_M}_fused_f32")
        if dtype == torch.float64:
            check(all(int(sf) == 1 for sf in run["safety"]),
                  f"{tag} safety {run['safety']}")
        else:
            check("snap" in run["timings"]["launches_per_replay"],
                  f"{tag} the projection did not run as a graph")
        if dtype == torch.float32 and rec is not None:
            print(f"{tag} record: steps {rec['steps']}, safety {rec['safety']}")
            check(all(int(a) <= b + 1
                      for a, b in zip(run["steps"], rec["steps"]))
                  and all(int(sf) == 1 for sf in run["safety"]),
                  f"{tag} not certified every step in at most the JAX f32 "
                  f"record's steps plus one")
        out[key] = {"steps": run["steps"].tolist(),
                    "safety": run["safety"].tolist(),
                    "dm": run["dm"].tolist(), "de": run["de"].tolist(),
                    "step_wall_ms": [1e3 * w for w in walls],
                    "launches": launches}
        if dtype == torch.float32:
            # the same evolution on the host loop, each step warm-started
            # from the last solution (the first from the initial state);
            # each step's certificate read after the evolution
            seen = []

            def solver(system, **kw):
                x, info = wrappers.cgmres_wrapper(system, **kw)
                seen.append((system, x, info["deviation"]))
                return x, info

            _reset_launches()
            t0 = time.perf_counter()
            ev = evolve("swe", N=EVOLVE_N, M=SWE_M, k=F32_K, tol=tol,
                        T=EVOLVE_T, pre=pre, warm_start=True, device=DEVICE,
                        dtype=dtype, solver=solver)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ev_launches = _read_launches()
            ev_tag = f"[f32 swe_M{SWE_M}_evolve_warm_float32]"
            certs = [_swe_certificate(system, x) for system, x, _ in seen]
            print(f"{ev_tag} warm-started evolve (host loop): steps "
                  f"{ev['steps']}, safety {ev['safety']}, dm "
                  f"{ev['dm'].tolist()}, de {ev['de'].tolist()}; wall "
                  f"{wall:.3f} s")
            for i, ((_, _, dev), cert) in enumerate(zip(seen, certs)):
                print(f"{ev_tag} step {i + 1}: certified deviation "
                      f"{dev:.3e}; mass {cert[0][0]:.3e} (floor "
                      f"{cert[0][1]:.3e}), energy {cert[1][0]:.3e} (floor "
                      f"{cert[1][1]:.3e})")
            _f32_launch_gate(ev_tag, ev_launches, dtype)
            check(all(sf is True for sf in ev["safety"])
                  and all(st <= F32_K for st in ev["steps"]),
                  f"{ev_tag} not certified every step: safety "
                  f"{ev['safety']}")
            check(all(d <= f for cert in certs for d, f in cert),
                  f"{ev_tag} a step's deviation above its certificate's "
                  f"floor: {certs}")
            # the host loop times no step alone: the evolution's wall
            out[f"swe_M{SWE_M}_evolve_warm_float32"] = {
                "steps": ev["steps"], "safety": ev["safety"],
                "dm": ev["dm"].tolist(), "de": ev["de"].tolist(),
                "certified": [dev for _, _, dev in seen],
                "mass_energy_and_floors": certs,
                "step_wall_ms": None, "wall_s": wall,
                "launches": ev_launches}
        del pre, run
        torch.cuda.empty_cache()
    return out


def _f32_batched_rows():
    """``cgmres_many`` in f32 (mixed by default, as the JAX package's) and its
    f64 twin on the items of ``swe_M512_snc_B8`` (the ninth slice's row) and
    of ``heat_M1024_amg_B8`` (the eleventh slice's), at k=20 and the chip rows' tolerances
    (swe 4e-7·||b||, heat 1e-6·||b|| of the unperturbed system): every f32
    item's steps its own single device-core solve's in the same modes, the
    block forms' f32 instantiations launched, the median wall of
    ``F32_SOLVES`` batched solves beside the twin's."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import heat, swe
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    ref = _reference_script()
    out = {}
    for problem, M, rtol in (("swe", SWE_M, F32_SWE_RTOL),
                             ("heat", HEAT_M, F32_HEAT_RTOL)):
        for dtype in (torch.float32, torch.float64):
            key = (f"{problem}_M{M}_{'snc' if problem == 'swe' else 'amg'}"
                   f"_B8_{str(dtype)[6:]}")
            tag = f"[f32 {key}]"
            model = swe if problem == "swe" else heat
            s = model.linforms(M=M, device=DEVICE, dtype=dtype)
            pre = default_pre_builder(problem)(s)
            z0 = s.z0.double().cpu().numpy()
            if problem == "swe":
                states = ref.batch_states("swe_M512_snc_B8", z0)
            else:
                field = ref.heat_smooth_field(M, z0)
                states = [z0 + 0.02 * i * field for i in range(HEAT_B)]
            items = [s.step_update(torch.as_tensor(z, dtype=dtype,
                                                   device=DEVICE))
                     for z in states]
            Bs = torch.stack([t.b for t in items])
            cons = [t.constraints() for t in items]
            tol = rtol * float(torch.linalg.norm(s.b.double()))

            def many():
                return cgmres_many(s.A, Bs, cons, k=F32_K, tol=tol, pre=pre)

            _timed(many, reps=1)
            (X, info), walls = _timed(many, reps=F32_SOLVES)
            _reset_launches()
            many()
            torch.cuda.synchronize()
            launches = _read_launches()
            singles = [cgmres(s.A, t.b, k=F32_K, tol=tol,
                              constraints=t.constraints(), pre=pre,
                              loop="while", snap=False, f32_reduce=False)[1]
                       for t in items]
            print(f"{tag} steps {info['steps'].tolist()} (single solves "
                  f"{[i['steps'] for i in singles]}), safety "
                  f"{info['safety'].tolist()}, deviation max "
                  f"{float(info['deviation'].max()):.3e}; walls {_ms(walls)} ms"
                  f" (median {1e3 * _median(walls):.3f})")
            _f32_launch_gate(tag, launches, dtype)
            block = "dia_spmm" if problem == "swe" else "stencil_spmm"
            check(launches[block] > 0, f"{tag} no launch of {block}")
            check([int(v) for v in info["steps"]]
                  == [i["steps"] for i in singles]
                  and [int(v) for v in info["safety"]]
                  == [{None: 0, True: 1, False: 2}[i["safety"]]
                      for i in singles],
                  f"{tag} items' steps or latch differ from their single "
                  f"solves'")
            check(bool(torch.isfinite(X).all()), f"{tag} not finite")
            out[key] = {"steps": info["steps"].tolist(),
                        "wall_ms": 1e3 * _median(walls),
                        "walls_ms": [1e3 * w for w in walls],
                        "deviation_max": float(info["deviation"].max()),
                        "launches": launches}
            del s, pre, items, Bs, cons, X
            torch.cuda.empty_cache()
    return out


def _f32_anchors(record):
    """The polynomial anchors in f32 on the device core, beside their f64
    twins: heat M=256 with cheb8 and heat M=64 with neu4, k=60, tol 1e-7
    absolute (the third slice's certified anchors), so that kernels #3 and #4 run in
    f32 on a solve; each f32 solve held to the JAX f32 record of its
    configuration; median walls of ``F32_SOLVES`` solves."""
    import torch

    from structurepreservingiterativesolvers_torch.models import heat
    from structurepreservingiterativesolvers_torch.solvers import cgmres

    builders = _poly_builders()
    out = {}
    for M, short, kernel in ((256, "cheb8", "cheb_apply"),
                             (64, "neu4", "neumann_apply")):
        for dtype in (torch.float32, torch.float64):
            key = f"heat_M{M}_{short}_{str(dtype)[6:]}"
            tag = f"[f32 {key}]"
            s = heat.linforms(M=M, device=DEVICE, dtype=dtype)
            pre = builders[short](s)

            def solve(s=s, pre=pre):
                return cgmres(s.A, s.b, k=60, tol=HEAT_TOL,
                              constraints=s.constraints(), pre=pre,
                              loop="while")

            _timed(solve, reps=1)
            (x, info), walls = _timed(solve, reps=F32_SOLVES)
            _reset_launches()
            solve()
            torch.cuda.synchronize()
            launches = _read_launches()
            print(f"{tag} steps {info['steps']}, safety {info['safety']}, "
                  f"deviation {info['deviation']:.3e}; walls {_ms(walls)} ms")
            _f32_launch_gate(tag, launches, dtype)
            check(launches[kernel] > 0, f"{tag} no launch of {kernel}")
            entry = record.get(f"heat_M{M}_{short}_f32")
            if dtype == torch.float32 and entry is not None:
                rec = entry["cgmres"]
                scale = max([abs(v) for v in entry["targets"].values()]
                            + [1.0])
                bar = max(10.0 * max(rec["certified"].values()),
                          F32_DEV_SCALE * scale)
                print(f"{tag} record: steps {rec['steps']}, safety "
                      f"{rec['safety']}, certified {rec['certified']} (bar "
                      f"{bar:.3e})")
                check(info["safety"] == rec["safety"]
                      and abs(info["steps"] - rec["steps"]) <= F32_STEPS
                      and info["deviation"] <= bar,
                      f"{tag} off the JAX f32 record")
            out[key] = {"steps": info["steps"], "safety": info["safety"],
                        "deviation": info["deviation"],
                        "wall_ms": 1e3 * _median(walls), "launches": launches}
            del s, pre
    return out


def phase_f32(record):
    """The fifteenth slice: the port's f32 storage mode at full width on the
    card, each row beside its f64 twin in this call (``_f32_kernels``,
    ``_f32_timed_rows``, ``_f32_fused``, ``_f32_batched_rows``,
    ``_f32_anchors``), held to ``reference/slice15.json``.  Prints the
    ``[f32]`` JSON line and returns the kernels' f32 times, the mixed #1's
    entry of the kernel line and its launches by path."""
    import torch

    from structurepreservingiterativesolvers_torch.models import heat, swe

    t0 = time.perf_counter()
    swe32 = swe.linforms(M=SWE_M, device=DEVICE, dtype=torch.float32)
    heat32 = heat.linforms(M=HEAT_M, device=DEVICE, dtype=torch.float32)
    times, mixed_err = _f32_kernels(swe32, heat32)
    del swe32, heat32
    torch.cuda.empty_cache()
    rows, launches, profiles = _f32_timed_rows(record)
    fused = _f32_fused(record)
    batched = _f32_batched_rows()
    anchors = _f32_anchors(record)
    paths = {**launches, **{k: v["launches"] for k, v in fused.items()},
             **{k: v["launches"] for k, v in batched.items()},
             **{k: v["launches"] for k, v in anchors.items()}}
    mixed_paths = {k: n["dia_spmv_mixed"] for k, n in paths.items()
                   if n["dia_spmv_mixed"]}
    check(mixed_paths, "no f32 path launched the mixed #1")

    def ratio(key):
        a, b = rows[f"{key}_float32"], rows[f"{key}_float64"]
        return {"runtime": a["runtime"] / b["runtime"],
                "gmres": a["time_gmres"] / b["time_gmres"]}

    summary = {
        "rows": rows, "profiles": profiles,
        "ratios": {key[:-len("_float32")]: ratio(key[:-len("_float32")])
                   for key in rows if key.endswith("_float32")},
        "fused": {k: {kk: v[kk] for kk in ("steps", "safety", "dm", "de",
                                           "step_wall_ms")}
                  for k, v in fused.items()},
        "batched": {k: {kk: v[kk] for kk in ("steps", "wall_ms", "walls_ms",
                                             "deviation_max")}
                    for k, v in batched.items()},
        "anchors": {k: {kk: v[kk] for kk in ("steps", "safety", "deviation",
                                             "wall_ms")}
                    for k, v in anchors.items()},
        "kernels": times, "seconds": time.perf_counter() - t0}
    print("[f32] " + json.dumps(summary))
    key = f"mixed_swe M={SWE_M} A"
    entry = {"name": "dia_spmv_mixed", "route": "cuda",
             "source": "structurepreservingiterativesolvers_torch/csrc/"
                       "dia_spmv.cu",
             "replaces": "structurepreservingiterativesolvers_tpu/ops/dd.py:213",
             "replaces_note": "ops/dd.py::spmv_dia, the double-f32 DIA product "
                              "of the JAX package's f32 certificates (plain "
                              "XLA there; its TPU kernel for f32 A @ x is "
                              "ops/pallas_spmv.py:91)",
             "launches": sum(mixed_paths.values()),
             "launches_by_path": mixed_paths,
             "max_abs_err": mixed_err, "timed_at": key,
             **{k: times[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
             "times": {k: v for k, v in times.items()
                       if k.startswith("mixed_")}}
    return times, entry, paths


# the seventeenth slice: f32 storage on every path the JAX package takes it
# (phase 33; phase 31's f32 rows in ``_sharded_f32``).  Each f32 row beside
# its f64 twin in this call and, where one exists, the JAX f32 record of its
# size (``reference/slice17.json``): lkdvRK M=400 (3, 2) at tol 1e-3 and
# (5, 4) at 1e-7 (k=50, the RAS + Neumann composite cast from phase 14's
# f64 build), the lkdv hard general solve, the f32 evolutions, heat P2
# M=512 with the greedy AMG at ``P2_F32_RTOL``·||b|| (the tolerance at which
# the JAX f32 records at M=16, 32 and 64 certify: at 1e-5 and 1e-6 they run
# to k), the batched rows.  The certified deviation of an lkdvRK row within
# max(10x the JAX M=20 record's, ``F32_DEV_SCALE`` of the invariants'
# scale), of a heat P2 row within max(10x the largest of the M=16, 32 and
# 64 records', ``F32_DEV_SCALE`` of its scale), the sweep's per-step errors within ``SWEEP_GAP`` times the JAX
# package's own f32-f64 gap at the record's size of the f64 sweep run here.
# ``KEEP17`` holds, between the phases, the operators this phase reuses.
KEEP17 = {}
P2_F32_RTOL, RK_F32_K, SWEEP_GAP = 1e-4, 50, 10.0
F32_KERNEL_RTOL, SHARD_F32_X = 1e-5, 1e-5
RK17 = (LKDVRK_ROWS[0], LKDVRK_ROWS[2])


def _gate17(tag, launches, upcast_ok=False, kernels=True):
    """An f32 row launched only the f32 and mixed instantiations (every
    launch of each kernel with an f32 counter is f32), plus, where
    ``upcast_ok``, kernel #1's f64 launches on a stage map's kept upcast
    operator (``dia_spmv_upcast``), counted apart; and, where ``kernels``
    (every path but heat P2 M=512 with ``cgs2``: its operators and levels
    are all ELL, torch ops), at least one f32 launch.  On a CUDA tensor no
    wrapper has a plain path."""
    launches = {k: launches.get(k, 0) for k in _launch_counters()}
    ran = {k: launches[k] for k in F32_KERNELS if launches[k]}
    f32 = {k: launches[f"{k}_f32"] for k in F32_KERNELS}
    up = launches["dia_spmv_upcast"]
    other = {k: n - f32[k] - (up if k == "dia_spmv" else 0)
             for k, n in ran.items()}
    print(f"{tag} launches {ran}; f32 { {k: f32[k] for k in ran} }; mixed #1 "
          f"{launches['dia_spmv_mixed']} (windowed "
          f"{launches['dia_spmv_mixed_window']}); f64 #1 on an upcast "
          f"operator {up}")
    check(any(f32.values()) or not kernels, f"{tag} no f32 launch")
    check(not any(other.values()), f"{tag} launches that are neither f32 nor "
                                   f"a counted upcast: {other}")
    check(upcast_ok or up == 0, f"{tag} {up} f64 launches on an upcast "
                                "operator")


def _scale17(s):
    """The invariants' scale of an lkdvRK or lkdv system: its largest
    target's magnitude, at least 1."""
    return max([abs(float(getattr(s, a))) for a in ("m0", "mo0", "e0")
                if hasattr(s, a)] + [1.0])


def _f32_rk_rows(record7, record17, rk):
    """(a) lkdvRK (3, 2) through ``time_cgmres`` on both loops with ``cgs2``
    and ``cgs2_fused``, and (b) (5, 4) on the device core, each f32 row
    beside its f64 twin: both certified, the f32 certified deviation within
    max(10x the JAX M=20 f32 record's, ``F32_DEV_SCALE`` of the scale), the
    true residual below tol (at (5, 4) where the JAX M=20 record's is), the
    f32 launches only f32 or mixed, or f64 on the StageKron inner's kept
    upcast mass matrix.  Returns the rows and their launches."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        certified_deviations,
        time_cgmres,
    )
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        clear_core_cache,
    )

    f32, f64 = torch.float32, torch.float64
    rows, paths = {}, {}
    name = RK17[0]
    cfg = record7[name]["config"]
    rec = record17["lkdvrk_M20_f32"]["cgmres"]
    for loop in ("host", "while"):
        for ortho in ("cgs2", "cgs2_fused"):
            out = {}
            for dtype in (f32, f64):
                s, pre = rk[name][dtype]
                key = f"{name}_{loop}_{ortho}_{str(dtype)[6:]}"
                tag = f"[f32-rest {key}]"
                _reset_launches()
                t0 = time.perf_counter()
                o = time_cgmres("lkdvrk", k=RK_F32_K, tol=cfg["tol"],
                                pre_builder=lambda system, pre=pre: pre,
                                device=DEVICE, loop=loop, ortho=ortho,
                                dtype=dtype, **cfg["params"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _read_launches()
                devs = {nm: o["conservation"][f"cgmres_{nm}"]
                        for nm in o["invariant_names"]}
                print(f"{tag} time_cgmres wall {wall:.2f} s; gmres "
                      f"{o['gmres_steps']} steps {1e3 * o['time_gmres']:.3f} "
                      f"ms; cgmres {o['steps']} steps "
                      f"({o['constrained_steps']} constrained) "
                      f"{1e3 * o['runtime']:.3f} ms, safety {o['safety']}, "
                      f"snap {1e3 * o.get('time_snap', 0.0):.3f} ms, residual"
                      f" {o['res_final']:.4e} (tol {o['tol_effective']:.1e});"
                      f" certified deviations {devs}")
                out[dtype] = o
                if dtype == f32:
                    _gate17(tag, launches, upcast_ok=True)
                    check(launches["dia_spmv_upcast"] > 0,
                          f"{tag} the StageKron inner never ran f64")
                    if ortho == "cgs2_fused":
                        check(launches["fused_update_matvec_f32"] > 0,
                              f"{tag} #5 in f32 never launched")
                    paths[key] = launches
                rows[key] = {k: o[k] for k in (
                    "steps", "gmres_steps", "constrained_steps", "safety",
                    "runtime", "time_gmres", "res_final")}
                rows[key].update(deviations=devs,
                                 time_snap=o.get("time_snap", 0.0))
                clear_core_cache()
            o32, o64 = out[f32], out[f64]
            s32 = rk[name][f32][0]
            dev = max(rows[f"{name}_{loop}_{ortho}_float32"][
                "deviations"].values())
            bar = max(10.0 * max(rec["certified"].values()),
                      F32_DEV_SCALE * _scale17(s32))
            tag = f"[f32-rest {name}_{loop}_{ortho}]"
            print(f"{tag} f32 against its f64 twin: steps {o32['steps']} "
                  f"({o64['steps']}), safety {o32['safety']} "
                  f"({o64['safety']}), wall ratio "
                  f"{o32['runtime'] / o64['runtime']:.3f}; certified "
                  f"deviation {dev:.3e} (bar {bar:.3e}); JAX M=20 f32 record:"
                  f" {rec['steps']} steps, safety {rec['safety']}")
            check(o32["safety"] is o64["safety"] is True,
                  f"{tag} safety f32 {o32['safety']}, f64 {o64['safety']}")
            check(dev <= bar, f"{tag} certified deviation {dev:.3e} > {bar:.3e}")
            check(o32["res_final"] < o32["tol_effective"],
                  f"{tag} residual {o32['res_final']:.3e}")
    # (b) (5, 4) on the device core
    name = RK17[1]
    cfg = record7[name]["config"]
    rec = record17.get("lkdvrk_M20_deg5_s4_f32", {}).get("cgmres")
    tol = cfg["tol"]
    out = {}
    for dtype in (f32, f64):
        s, pre = rk[name][dtype]
        key = f"{name}_while_{str(dtype)[6:]}"
        tag = f"[f32-rest {key}]"

        def solve(s=s, pre=pre):
            return wrappers.cgmres_wrapper(s, k=RK_F32_K, tol=tol, pre=pre,
                                           loop="while")

        solve()
        (x, info), walls = _timed(solve, reps=3)
        _reset_launches()
        solve()
        torch.cuda.synchronize()
        launches = _read_launches()
        devs = certified_deviations(s, x)
        res = float(torch.linalg.norm((s.A @ x - s.b).double()))
        print(f"{tag} steps {info['steps']} ({info['constrained_steps']} "
              f"constrained), safety {info['safety']}, residual {res:.3e} "
              f"(tol {tol:.0e}), certified deviations {devs}; wall, median "
              f"of 3: {1e3 * _median(walls):.3f} ms ({_ms(walls)})")
        out[dtype] = (info, devs, res, _median(walls))
        if dtype == f32:
            _gate17(tag, launches, upcast_ok=True)
            paths[key] = launches
        rows[key] = {"steps": info["steps"], "safety": info["safety"],
                     "constrained_steps": info["constrained_steps"],
                     "res_final": res, "deviations": devs,
                     "wall_ms": 1e3 * _median(walls)}
        clear_core_cache()
    (i32, d32, r32, w32), (i64, _, _, w64) = out[f32], out[f64]
    tag = f"[f32-rest {name}_while]"
    bar = max(10.0 * max(rec["certified"].values()) if rec else 0.0,
              F32_DEV_SCALE * _scale17(rk[name][f32][0]))
    print(f"{tag} f32 against its f64 twin: steps {i32['steps']} "
          f"({i64['steps']}), safety {i32['safety']} ({i64['safety']}), "
          f"wall ratio {w32 / w64:.3f}; certified deviation "
          f"{max(d32.values()):.3e} (bar {bar:.3e}); JAX M=20 f32 record: "
          + ("none" if rec is None else
             f"{rec['steps']} steps, safety {rec['safety']}, residual "
             f"{rec['true_residual']:.3e}"))
    check(i64["safety"] is True, f"{tag} f64 twin not certified")
    check(i32["safety"] is (rec["safety"] if rec else True),
          f"{tag} f32 safety {i32['safety']}")
    if i32["safety"]:
        check(max(d32.values()) <= bar, f"{tag} certified deviation "
                                        f"{max(d32.values()):.3e}")
    if rec is not None and rec["true_residual"] < tol:
        check(r32 < tol, f"{tag} residual {r32:.3e} not below {tol:.0e}")
    return rows, paths


def _f32_general(record17):
    """(c) The lkdv hard general solve (M=100, degree 3, the energy a
    ``GeneralConstraint``) in f32 on both loops and its f64 twin: the f64
    twin certified, the f32 loops' latches alike and equal to the JAX f32
    record's (lkdv M=50: an f32 evaluation of a callable g is noisy at
    eps32 of its terms, over the f64 latch's floor), the f32 launches f32
    or mixed only (#1 and the Hessian's #1b in f32, the quadratic
    constraints' f64 reduction through the mixed #1).  Returns the rows and
    the launches."""
    import torch

    from structurepreservingiterativesolvers_torch.constraints import (
        GeneralConstraint,
    )
    from structurepreservingiterativesolvers_torch.models import lkdv
    from structurepreservingiterativesolvers_torch.solvers import cgmres
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        clear_core_cache,
    )

    rec = record17["lkdv_M50_general_f32"]["cgmres"]
    rows, paths = {}, {}
    for dtype in (torch.float32, torch.float64):
        s = lkdv.linforms(M=100, degree=3, device=DEVICE, dtype=dtype)
        mass, mom, _ = s.constraints()

        def energy(x, s=s):
            u, _, w = torch.split(x, s.n0)
            return (0.5 * torch.dot(w, s.Mmat @ w)
                    - 0.5 * torch.dot(u, s.Mmat @ u) - s.e0)

        cons = [mass, mom, GeneralConstraint(func=energy, name="energy")]
        for loop in ("host", "while"):
            key = f"lkdv_hard_general_{loop}_{str(dtype)[6:]}"
            tag = f"[f32-rest {key}]"
            cgmres(s.A, s.b, k=50, tol=1e-6, constraints=cons, loop=loop)
            _reset_launches()
            t0 = time.perf_counter()
            x, info = cgmres(s.A, s.b, k=50, tol=1e-6, constraints=cons,
                             loop=loop)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_launches()
            print(f"{tag} steps {info['steps']} ({info['constrained_steps']} "
                  f"constrained), safety {info['safety']}, deviation "
                  f"{info['deviation']:.3e}, residual {info['res'][-1]:.3e}, "
                  f"wall {1e3 * wall:.1f} ms")
            if dtype == torch.float32:
                _gate17(tag, launches)
                check(launches["dia_spmm_f32"] > 0,
                      f"{tag} the Hessian's #1b in f32 never launched")
                paths[key] = launches
            rows[key] = {"steps": info["steps"], "safety": info["safety"],
                         "deviation": info["deviation"],
                         "constrained_steps": info["constrained_steps"],
                         "wall_ms": 1e3 * wall}
            clear_core_cache()
    tag = "[f32-rest lkdv_hard_general]"
    h, w = (rows[f"lkdv_hard_general_{lp}_float32"] for lp in ("host", "while"))
    print(f"{tag} f32 latches: host {h['safety']}, device core {w['safety']};"
          f" the JAX f32 record (M=50): {rec['safety']} after {rec['steps']} "
          f"steps, deviation {rec['deviation']:.3e}")
    check(rows["lkdv_hard_general_host_float64"]["safety"] is True
          and rows["lkdv_hard_general_while_float64"]["safety"] is True,
          f"{tag} the f64 twins did not certify")
    check(h["safety"] == w["safety"] == rec["safety"],
          f"{tag} f32 latches {h['safety']}, {w['safety']} against the "
          f"record's {rec['safety']}")
    return rows, paths


def _f32_rk_evolutions(record17, rk):
    """(d) A 10-step f32 ``fused_evolve("lkdvrk")`` at (3, 2) (every step
    certified), and the error sweep's ``run_single(loop="while")`` in f32
    beside its f64 run in this call: every step certified, each step's L2
    error within ``SWEEP_GAP`` times the JAX package's largest f32-f64 gap
    at the record's size of the f64 run's.  Returns the rows and launches."""
    import tempfile

    import numpy as np
    import torch

    from structurepreservingiterativesolvers_torch.experiments.error_sweep import (
        run_single,
    )
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        clear_core_cache,
    )

    f32 = torch.float32
    name = RK17[0]
    params = dict(N=10, M=400, degree=3, tstages=2)
    pre = rk[name][f32][1]
    rows, paths = {}, {}
    tag = f"[f32-rest {name}_fused_evolve]"
    fused_evolve("lkdvrk", k=RK_F32_K, tol=1e-3, pre=pre, dtype=f32,
                 device=DEVICE, **params)
    _reset_launches()
    t0 = time.perf_counter()
    r = fused_evolve("lkdvrk", k=RK_F32_K, tol=1e-3, pre=pre, dtype=f32,
                     device=DEVICE, **params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = r["timings"]["launches"]
    print(f"{tag} steps {r['steps'].tolist()}, safety {r['safety'].tolist()},"
          f" dm {r['dm'][-1]:.3e}, de {r['de'][-1]:.3e}; wall {wall:.3f} s")
    _gate17(tag, launches, upcast_ok=True)
    check(all(int(v) == 1 for v in r["safety"]), f"{tag} safety {r['safety']}")
    rows["fused_evolve"] = {"steps": r["steps"].tolist(),
                            "safety": r["safety"].tolist(), "wall_s": wall}
    paths[f"{name}_fused_evolve_f32"] = launches
    clear_core_cache()
    sweep = record17["lkdvrk_M20_sweep_f32"]
    key = next(iter(sweep["f32"]))
    gap_rec = float(np.max(np.abs(np.asarray(sweep["f32"][key]["err"])
                                  - np.asarray(sweep["f64"][key]["err"]))))
    runs = {}
    for dtype in (f32, torch.float64):
        _reset_launches()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            runs[dtype] = run_single("CGMRES", 3, 2, 1e-3, N=10, M=400,
                                     k=RK_F32_K, tmpdir=tmp, loop="while",
                                     dtype=dtype, device=DEVICE)
        torch.cuda.synchronize()
        runs[dtype]["wall"] = time.perf_counter() - t0
        if dtype == f32:
            launches = _read_launches()
            _gate17(f"[f32-rest {name}_sweep]", launches, upcast_ok=True)
            paths[f"{name}_sweep_f32"] = launches
        clear_core_cache()
    a, b = runs[f32], runs[torch.float64]
    gap = np.abs(np.asarray(a["err"]) - np.asarray(b["err"]))
    tag = f"[f32-rest {name}_sweep]"
    print(f"{tag} run_single(loop='while'): f32 steps {a['steps']}, safety "
          f"{a['safety']}, wall {a['wall']:.2f} s; f64 steps {b['steps']}, "
          f"wall {b['wall']:.2f} s; errors f32 "
          f"{['%.6e' % e for e in a['err']]}, f64 "
          f"{['%.6e' % e for e in b['err']]}; largest gap {gap.max():.3e} "
          f"(the JAX package's at M=20, N=3: {gap_rec:.3e}, bar "
          f"{SWEEP_GAP * gap_rec:.3e})")
    check(all(v is True for v in a["safety"]), f"{tag} safety {a['safety']}")
    check(float(gap.max()) <= SWEEP_GAP * gap_rec,
          f"{tag} f32 errors {gap.max():.3e} from the f64 run's")
    rows["sweep"] = {"steps": a["steps"], "steps_f64": b["steps"],
                     "err": list(map(float, a["err"])),
                     "err_f64": list(map(float, b["err"])),
                     "gap": float(gap.max()), "gap_record": gap_rec,
                     "wall_s": a["wall"], "wall_f64_s": b["wall"]}
    return rows, paths


def _f32_p2(record17, p2):
    """(e) heat P2 M=512 with the greedy AMG cast from phase 28's f64 build
    (the levels' sizes equal), k=60, tol ``P2_F32_RTOL``·||b||, on both
    loops and with ``cgs2_fused``, beside the f64 device-core twin: the f32
    rows held to the JAX f32 records' latch at that tolerance (certified),
    running to k where the records at M=32 and 64 do (the f32 residual
    floor relative to ||b|| grows with M), each certified deviation at most
    max(10x the largest of the records', ``F32_DEV_SCALE`` of the
    invariants' scale) (no record of this size); launches f32 only.
    Returns the rows and launches."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        certified_deviations,
    )
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        clear_core_cache,
    )
    from structurepreservingiterativesolvers_torch.utils.cast import astype

    s64, pre64 = p2
    s32, pre32 = astype((s64, pre64), torch.float32)
    sizes = [L.A.shape[0] for L in pre32.levels]
    check(sizes == [L.A.shape[0] for L in pre64.levels]
          and all(L.A.dtype == torch.float32 for L in pre32.levels),
          f"[f32-rest {P2}] the cast hierarchy's levels {sizes}")
    recs = [record17[f"heat_P2_M{m}_f32"]["solves"][repr(P2_F32_RTOL)]
            for m in (16, 32, 64) if f"heat_P2_M{m}_f32" in record17]
    scale = max(abs(float(s64.m0)), abs(float(s64.old_energy)), 1.0)
    bar = max(10.0 * max(r["deviation"] for r in recs),
              F32_DEV_SCALE * scale)
    print(f"[f32-rest {P2}] levels {sizes}; the JAX f32 records at tol "
          f"{P2_F32_RTOL:.0e}·||b||: steps {[r['steps'] for r in recs]}, "
          f"safety {[r['safety'] for r in recs]}, deviations "
          f"{[r['deviation'] for r in recs]}; the bar {bar:.3e}")
    rows, paths = {}, {}
    for s, pre, dtype, runs in ((s32, pre32, "float32",
                                 (("host", "cgs2"), ("while", "cgs2"),
                                  ("host", "cgs2_fused"),
                                  ("while", "cgs2_fused"))),
                                (s64, pre64, "float64",
                                 (("while", "cgs2"),))):
        tol = P2_F32_RTOL * float(torch.linalg.norm(s.b.double()))
        for loop, ortho in runs:
            key = f"{P2}_{loop}_{ortho}_{dtype}"
            tag = f"[f32-rest {key}]"

            def solve(s=s, pre=pre, loop=loop, ortho=ortho, tol=tol):
                return wrappers.cgmres_wrapper(s, k=P2_K, tol=tol, pre=pre,
                                               loop=loop, ortho=ortho)

            solve()
            (x, info), walls = _timed(solve, reps=3)
            _reset_launches()
            solve()
            torch.cuda.synchronize()
            launches = _read_launches()
            devs = certified_deviations(s, x)
            res = float(torch.linalg.norm((s.A @ x - s.b).double()))
            print(f"{tag} steps {info['steps']} ({info['constrained_steps']}"
                  f" constrained), safety {info['safety']}, residual "
                  f"{res:.3e} (tol {tol:.3e}), certified deviations {devs}; "
                  f"wall, median of 3: {1e3 * _median(walls):.3f} ms")
            if dtype == "float32":
                _gate17(tag, launches, kernels=ortho == "cgs2_fused")
                if ortho == "cgs2_fused":
                    check(launches["fused_update_matvec_f32"]
                          == info["steps"] > 0,
                          f"{tag} #5 in f32 {launches['fused_update_matvec_f32']}"
                          f" over {info['steps']} steps")
                check(info["safety"] is all(r["safety"] for r in recs),
                      f"{tag} safety {info['safety']} against the records'")
                # where the records above M=16 run to k at this tolerance
                # (the f32 residual floor), the row does too
                if all(r["steps"] == P2_K for r in recs[1:]):
                    check(info["steps"] == P2_K,
                          f"{tag} {info['steps']} steps; the records run to "
                          f"k={P2_K}")
                paths[key] = launches
            else:
                check(info["safety"] is True, f"{tag} f64 twin not certified")
            check(max(abs(v) for v in devs.values()) <= bar,
                  f"{tag} certified deviations {devs} (bar {bar:.3e})")
            rows[key] = {"steps": info["steps"], "safety": info["safety"],
                         "constrained_steps": info["constrained_steps"],
                         "res_final": res, "tol": tol, "deviations": devs,
                         "wall_ms": 1e3 * _median(walls)}
            clear_core_cache()
    return rows, paths, (s32, pre32)


def _f32_batched17(rk, p2_32):
    """(f) ``cgmres_many`` in f32 on ``lkdvrk_M400_deg3_s2_B8`` and
    ``heat_P2_M512_amg_B8``: every item certified, its steps its single
    f32 device-core solve's (the same modes: mixed, the f64 reduction, no
    projection); the launches f32 or mixed only.  Returns the rows and
    launches."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_torch.solvers import cgmres
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        clear_core_cache,
    )

    f32 = torch.float32
    ref = _reference_script()
    rows, paths = {}, {}
    s, pre = rk[RK17[0]][f32]
    p = ref.lkdvrk_field(s.fem, s.prob.mlength,
                         s.z0[:s.n0].double().cpu().numpy())
    states = torch.as_tensor(ref.lkdvrk_stage_states(
        p, RK_B, s.prob.ns, s.n0, s.prob.dt), device=DEVICE, dtype=f32)
    rk_items = [s.step_update(z) for z in states]
    s2, pre2 = p2_32
    field = torch.as_tensor(ref.heat_p2_field(s2.prob.fem(),
                                              s2.z0.double().cpu().numpy()),
                            device=DEVICE, dtype=f32)
    p2_items = [s2.step_update(s2.z0 + 0.02 * i * field) for i in range(P2_B)]
    for name, (A, items, pre_, k, tol) in {
            f"{RK17[0]}_B{RK_B}": (s.A, rk_items, pre, RK_F32_K, 1e-3),
            f"{P2}_amg_B{P2_B}": (s2.A, p2_items, pre2, P2_K, P2_F32_RTOL
                                  * float(torch.linalg.norm(
                                      s2.b.double())))}.items():
        tag = f"[f32-rest {name}]"
        Bs = torch.stack([t.b for t in items])
        cons = [t.constraints() for t in items]

        def many():
            return cgmres_many(A, Bs, cons, k=k, tol=tol, pre=pre_)

        many()
        (X, info), walls = _timed(many, reps=3)
        _reset_launches()
        many()
        torch.cuda.synchronize()
        launches = _read_launches()
        clear_core_cache()
        singles = [cgmres(A, t.b, k=k, tol=tol, pre=pre_, constraints=c,
                          loop="while", snap=False, f32_reduce=False)
                   for t, c in zip(items, cons)]
        clear_core_cache()
        print(f"{tag} B={len(items)}: steps {list(map(int, info['steps']))} "
              f"(single f32 solves {[i1['steps'] for _, i1 in singles]}), "
              f"safety {list(map(int, info['safety']))}, KKT deviation max "
              f"{max(info['deviation']):.3e}; wall, median of 3: "
              f"{1e3 * _median(walls):.3f} ms")
        _gate17(tag, launches, upcast_ok=True, kernels=A is s.A)
        for i, (_, i1) in enumerate(singles):
            check(int(info["safety"][i]) == 1,
                  f"{tag} item {i}: safety {info['safety'][i]}")
            check(int(info["steps"][i]) == i1["steps"],
                  f"{tag} item {i}: {info['steps'][i]} steps, its single "
                  f"solve {i1['steps']}")
        rows[name] = {"steps": list(map(int, info["steps"])),
                      "single_steps": [i1["steps"] for _, i1 in singles],
                      "wall_ms": 1e3 * _median(walls)}
        paths[f"{name}_f32"] = launches
    return rows, paths


def _f32_kernels17(rk):
    """(h) The f32 and mixed instantiations at this slice's shapes, each
    checked against its plain version (``F32_KERNEL_RTOL`` relative in
    f32, ``F32_MIXED_RTOL`` for the mixed and f64 forms, repeats bit-equal)
    and timed with L2 flushed against the f32 bound and cuSPARSE
    (``_f32_time``): #1 live and dense on lkdvRK (3, 2) A, the f64 #1 on
    the StageKron inner's kept upcast mass matrix (n0 = 1,600; with its
    plan), #1b at B = 8 on A, #1 and #1b on heat P2 M=256's DIA level, the
    mixed #1 on lkdv M=100's mass matrix, and #5 at n = 9,600, m = 8 and
    n = 1,050,625, m = 31.  Returns the times by label and the largest
    errors by kernel."""
    import torch

    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.kernels import ortho
    from structurepreservingiterativesolvers_torch.models import lkdv
    from structurepreservingiterativesolvers_torch.ops.sparse import matvec_f64

    f32 = torch.float32
    gen = torch.Generator(device=DEVICE).manual_seed(33)
    times, errs = {}, {"dia_spmv": 0.0, "dia_spmm": 0.0, "dia_spmv_mixed": 0.0,
                       "fused_update_matvec": 0.0}

    def held(kernel, label, y, ref, again, rtol):
        abs_err, rel = _rel_err(y, ref)
        print(f"[f32-rest] {label}: max|dy|/max|y| {rel:.3e} against the "
              f"plain version (bound {rtol:.0e}), a repeat equal "
              f"{bool(torch.equal(y, again))}")
        check(math.isfinite(rel) and rel <= rtol and torch.equal(y, again),
              f"[f32-rest] {label} disagrees with its plain version: "
              f"{rel:.3e}")
        errs[kernel] = max(errs[kernel], abs_err)

    s = rk[RK17[0]][f32][0]
    A = s.A
    n, nnz = A.shape[0], int(torch.count_nonzero(A.data))
    x = torch.randn(n, generator=gen, device=DEVICE, dtype=f32)
    plain = lambda: kd.dia_spmv_torch(A.data, A.offsets, A.wrap, x)  # noqa: E731
    held("dia_spmv", f"#1 f32 lkdvRK (3, 2) A (live {A.live().share:.3f})",
         A @ x, plain(), A @ x, F32_KERNEL_RTOL)
    dense = lambda: kd.dia_spmv_dense_cuda(A.data, A.offsets, A.wrap, x)  # noqa: E731
    held("dia_spmv", "#1 f32 lkdvRK (3, 2) A, dense", dense(), plain(),
         dense(), F32_KERNEL_RTOL)
    csr = _csr_dtype(s.A_csr, f32)
    for label, fn in (("live", lambda: A @ x), ("dense", dense)):
        times[f"dia_spmv_{RK17[0]} A {label}"] = _f32_time(
            f"#1 {RK17[0]} A, {label}", fn, plain, 4 * (nnz + 2 * n),
            2 * nnz, lambda: csr @ x, " (cuSPARSE f32 CSR)")
    X = torch.randn(8, n, generator=gen, device=DEVICE, dtype=f32).T
    plainB = lambda: kd.dia_spmm_torch(A.data, A.offsets, A.wrap, X)  # noqa: E731
    held("dia_spmm", f"#1b f32 {RK17[0]} A, B = 8", A @ X, plainB(), A @ X,
         F32_KERNEL_RTOL)
    Xc = X.contiguous()
    times[f"dia_spmm_{RK17[0]} A B=8"] = _f32_time(
        f"#1b {RK17[0]} A, B = 8", lambda: A @ X, plainB,
        4 * (nnz + 16 * n), 16 * nnz, lambda: torch.sparse.mm(csr, Xc),
        " (cuSPARSE f32 SpMM)")
    # the StageKron inner's mass matrix: the f64 #1 on its kept upcast
    M = s.Mmat
    up = M.upcast()
    x64 = torch.randn(M.shape[0], generator=gen, device=DEVICE,
                      dtype=torch.float64)
    y1, y2 = matvec_f64(M, x64), matvec_f64(M, x64)
    check(M.upcast() is up and up._launch is not None,
          "[f32-rest] the upcast mass matrix is not kept with its launch")
    held("dia_spmv", f"#1 f64 on the kept upcast {RK17[0]} Mmat (n0 = "
         f"{M.shape[0]})", y1,
         kd.dia_spmv_torch(up.data, up.offsets, up.wrap, x64), y2,
         F32_MIXED_RTOL)
    nz = int(torch.count_nonzero(up.data))
    times[f"dia_spmv_{RK17[0]} Mmat upcast f64"] = _f32_time(
        f"#1 f64 on the upcast {RK17[0]} Mmat", lambda: matvec_f64(M, x64),
        lambda: kd.dia_spmv_torch(up.data, up.offsets, up.wrap, x64),
        8 * (nz + 2 * M.shape[0]), 2 * nz,
        lambda c=_csr_dtype(s.Mh, torch.float64): c @ x64,
        " (cuSPARSE f64 CSR)")
    # heat P2 M=256's DIA level, kept by phase 30
    for lvl, L64 in enumerate(KEEP17.get("p2_m256_dia", ())):
        L = L64.astype(f32)
        n, nnz = L.shape[0], int(torch.count_nonzero(L.data))
        x = torch.randn(n, generator=gen, device=DEVICE, dtype=f32)
        plain = lambda L=L, x=x: kd.dia_spmv_torch(L.data, L.offsets, L.wrap, x)  # noqa: E731
        held("dia_spmv", f"#1 f32 heat P2 M=256 DIA level (n = {n})", L @ x,
             plain(), L @ x, F32_KERNEL_RTOL)
        c = _csr_dtype(_dia_csr(L64), f32)
        times[f"dia_spmv_heat_P2_M256 level n={n}"] = _f32_time(
            f"#1 heat P2 M=256 level (n = {n})", lambda L=L, x=x: L @ x, plain,
            4 * (nnz + 2 * n), 2 * nnz, lambda c=c, x=x: c @ x,
            " (cuSPARSE f32 CSR)")
        X = torch.randn(8, n, generator=gen, device=DEVICE, dtype=f32).T
        plainB = lambda L=L, X=X: kd.dia_spmm_torch(L.data, L.offsets, L.wrap, X)  # noqa: E731
        held("dia_spmm", f"#1b f32 heat P2 M=256 DIA level, B = 8", L @ X,
             plainB(), L @ X, F32_KERNEL_RTOL)
        times[f"dia_spmm_heat_P2_M256 level n={n} B=8"] = _f32_time(
            f"#1b heat P2 M=256 level (n = {n}), B = 8", lambda L=L, X=X: L @ X,
            plainB, 4 * (nnz + 16 * n), 16 * nnz,
            lambda c=c, Xc=X.contiguous(): torch.sparse.mm(c, Xc),
            " (cuSPARSE f32 SpMM)")
    # the mixed #1 on lkdv M=100's mass matrix (row (c)'s shape)
    lk = lkdv.linforms(M=100, degree=3, device=DEVICE, dtype=f32)
    M = lk.Mmat
    x = torch.randn(M.shape[0], generator=gen, device=DEVICE, dtype=f32)
    plain = lambda: kd.dia_spmv_mixed_torch(M.data, M.offsets, M.wrap, x)  # noqa: E731
    held("dia_spmv_mixed", "mixed #1 lkdv M=100 Mmat", matvec_f64(M, x),
         plain(), matvec_f64(M, x), F32_MIXED_RTOL)
    nz, n = int(torch.count_nonzero(M.data)), M.shape[0]
    times["mixed_lkdv M=100 Mmat"] = _f32_time(
        "mixed #1 lkdv M=100 Mmat", lambda: matvec_f64(M, x), plain,
        4 * nz + 4 * n + 8 * n, 2 * nz,
        lambda c=_csr_dtype(_dia_csr(M), torch.float64), x64=x.double():
        c @ x64, " (cuSPARSE f64 CSR on the upcast x, the upcast not timed)")
    # #5 in f32 at lkdvRK's and heat P2 M=512's shapes
    for n, m in ((LKDVRK_N, 8), (P2_N, 31)):
        Q = torch.randn(m, n, generator=gen, device=DEVICE, dtype=f32)
        w = torch.randn(n, generator=gen, device=DEVICE, dtype=f32)
        h = torch.randn(m, generator=gen, device=DEVICE, dtype=f32)
        out = ortho.fused_update_matvec(Q, w, h)
        ref = ortho.fused_update_matvec_torch(Q, w, h)
        again = ortho.fused_update_matvec(Q, w, h)
        for part, (a, b, c) in enumerate(zip(out, ref, again)):
            held("fused_update_matvec", f"#5 f32 n = {n}, m = {m} "
                 f"({('w1', 'u2')[part]})", a, b, c, F32_KERNEL_RTOL)
        times[f"fused_update_matvec n={n} m={m}"] = _f32_time(
            f"#5 n = {n}, m = {m}",
            lambda Q=Q, w=w, h=h: ortho.fused_update_matvec(Q, w, h),
            lambda Q=Q, w=w, h=h: ortho.fused_update_matvec_torch(Q, w, h),
            4 * (m * n + 2 * n), 4 * m * n)
    return times, errs


def phase_f32_rest(record7, record17, rk=None, p2=None):
    """Phase 33, the seventeenth slice: f32 storage on lkdvRK, the general
    constraints, heat P2, the error sweep and the batch, at full width on
    the card (rows (a)-(f) and the kernels of (h); (g) is phase 31's
    ``_sharded_f32``).  ``rk``: per lkdvRK row of ``RK17``, its f64 system
    and composite (phase 14's, cast here); ``p2``: heat P2 M=512's f64
    system and greedy AMG (phase 28's).  Without them they are built here.
    Prints the ``[f32-rest]`` JSON line; returns the kernels' times and
    errors and the launches by path."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.models import heat, lkdvrk
    from structurepreservingiterativesolvers_torch.utils.cast import astype

    t_phase = time.perf_counter()
    f32 = torch.float32
    if rk is None:
        rk = {}
        for name in RK17:
            cfg = record7[name]["config"]
            s = lkdvrk.linforms(device=DEVICE, **cfg["params"])
            rk[name] = (s, default_pre_builder("lkdvrk")(s))
    rk = {name: {torch.float64: sp, f32: astype(sp, f32)}
          for name, sp in rk.items()}
    if p2 is None:
        s = heat.linforms(M=P2_M, degree=2, device=DEVICE)
        p2 = (s, default_pre_builder("heat")(s))
    print(f"[f32-rest] set-up (casts) {time.perf_counter() - t_phase:.2f} s")
    secs, paths = {}, {}
    t0 = time.perf_counter()
    times, errs = _f32_kernels17(rk)
    secs["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rk_rows, pa = _f32_rk_rows(record7, record17, rk)
    paths.update(pa)
    secs["lkdvrk_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    general, pa = _f32_general(record17)
    paths.update(pa)
    secs["general"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    evolutions, pa = _f32_rk_evolutions(record17, rk)
    paths.update(pa)
    secs["evolutions"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2_rows, pa, p2_32 = _f32_p2(record17, p2)
    paths.update(pa)
    secs["heat_p2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched, pa = _f32_batched17(rk, p2_32)
    paths.update(pa)
    secs["batched"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    print("[f32-rest] " + json.dumps({
        "lkdvrk": rk_rows, "general": general, "evolutions": evolutions,
        "heat_p2": p2_rows, "batched": batched, "kernels": times,
        "seconds": secs}))
    print(f"[f32-rest] phase took {secs['phase']:.1f} s")
    return times, errs, paths


def _sharded_f32(mesh):
    """Phase 31's f32 rows (the seventeenth slice's (g)), one NCCL rank:
    the windowed mixed #1 (f32 window and data, f64 y) on swe M=512's A
    and heat M=1024's energy matrix against its plain version
    (``F32_MIXED_RTOL``, repeats bit-equal, on one rank the unsharded mixed
    launch's bits) and timed; then each f32 row beside its unsharded f32
    solve (the same steps and latch, x within ``SHARD_F32_X``·max|x|, heat
    M=1024 within 10x the JAX f32 record's own drift, ``pair``): swe
    M=512 with the skew-normal Chebyshev (tol 4e-7·||b||) on both loops,
    heat M=1024 with the AMG on the device core (tol 1e-6·||b||; its energy
    matrix's certificates through the windowed mixed #1), and a 3-step
    sharded f32 ``fused_evolve`` on swe M=512.  Returns the windowed mixed
    kernel's report and the launches by path."""
    import torch

    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.experiments.evolve import (
        fused_evolve,
    )
    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.kernels import dia_spmv as kd
    from structurepreservingiterativesolvers_torch.models import heat, swe
    from structurepreservingiterativesolvers_torch.ops.sparse import matvec_f64
    from structurepreservingiterativesolvers_torch.parallel import (
        gather,
        shard_matrix,
        shard_preconditioner,
        shard_system,
        shard_vector,
    )
    from structurepreservingiterativesolvers_torch.solvers import cgmres
    from structurepreservingiterativesolvers_torch.solvers.cgmres import (
        clear_core_cache,
    )

    t_phase = time.perf_counter()
    f32 = torch.float32
    gen = torch.Generator(device=DEVICE).manual_seed(34)
    # heat M=1024 runs to k at its f32 floor, where an f32 solve is settled
    # no closer than the JAX package's own drift under a one-ulp change of b
    rec15 = json.loads((PACKAGE / "reference" / "slice15.json").read_text())
    x_bar = {f"swe_M{SWE_M}_snc": SHARD_F32_X,
             f"heat_M{HEAT_M}_amg": max(
                 SHARD_F32_X,
                 10.0 * rec15[f"heat_M{HEAT_M}_amg_f32"]["own_drift"])}
    s = swe.linforms(M=SWE_M, device=DEVICE, dtype=f32)
    h = heat.linforms(M=HEAT_M, device=DEVICE, dtype=f32)
    win, err = {}, 0.0
    for label, M, A_csr in ((f"swe M={SWE_M} A", s.A, s.A_csr),
                            (f"heat M={HEAT_M} Emat", h.Emat, None)):
        tag = f"[sharded f32 {label}]"
        A = shard_matrix(M, mesh)
        x = torch.randn(M.shape[0], generator=gen, device=DEVICE, dtype=f32)
        xs = shard_vector(x, mesh)
        ext = A.window(xs)
        _reset_launches()
        y = A.matvec_f64(xs)
        again = A.matvec_f64(xs)
        torch.cuda.synchronize()
        counted = _read_launches()
        twin = kd.dia_spmv_window_mixed_torch(A.data, A.offsets, A.lo, ext)
        abs_err, rel = _rel_err(y, twin)
        bits = bool(torch.equal(gather(y, mesh), matvec_f64(M, x)))
        print(f"{tag} windowed mixed #1 (window {A.xchg.width}, "
              f"{'live' if A.live().pays else 'dense'} design): max|dy|/max|y|"
              f" {rel:.3e} against its plain version (bound "
              f"{F32_MIXED_RTOL:.0e}), a repeat equal "
              f"{bool(torch.equal(y, again))}, the unsharded mixed launch's "
              f"bits {bits}; counted {counted['dia_spmv_mixed_window']} "
              f"windowed of {counted['dia_spmv_mixed']} mixed launches")
        check(y.dtype == torch.float64 and rel <= F32_MIXED_RTOL
              and torch.equal(y, again), f"{tag} {rel:.3e}")
        check(counted["dia_spmv_mixed_window"] == 2
              and counted["dia_spmv_mixed"] == 2,
              f"{tag} counted {counted['dia_spmv_mixed_window']} windowed, "
              f"{counted['dia_spmv_mixed']} mixed")
        if mesh.size == 1:
            check(bits, f"{tag} on one rank the windowed mixed product must "
                        "give the unsharded bits")
        err = max(err, abs_err)
        nnz = int(torch.count_nonzero(A.data))
        rec = A._resolved(ext)
        c64 = _csr_dtype(A_csr if A_csr is not None else _dia_csr(M),
                         torch.float64)
        x64 = x.double()
        t = {"ms": _time_cold_ms(lambda: kd.launch_mixed(rec, ext)),
             "sharded_ms": _time_cold_ms(lambda: A.matvec_f64(xs)),
             "plain_ms": _time_cold_ms(lambda: kd.dia_spmv_window_mixed_torch(
                 A.data, A.offsets, A.lo, ext), reps=10),
             "library_ms": _time_cold_ms(lambda: c64 @ x64),
             "window": A.xchg.width, "n_local": A.n_local}
        # f32 data and window read once, f64 y written once; f64 operations
        t["bound_ms"], t["bound_by"] = _bound_ms(
            4 * nnz + 4 * A.xchg.width + 8 * A.n_local, 2 * nnz)
        print(f"{tag} times (L2 flushed): windowed mixed launch "
              f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
              f"{t['bound_by']}, at {t['bound_ms'] / t['ms']:.1%}), with the "
              f"window's exchange {t['sharded_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, cuSPARSE f64 CSR on the upcast x "
              f"{t['library_ms']:.4f} ms")
        win[label] = t
        del A, x, xs, ext, c64, x64
    win["max_abs_err"] = err
    paths, walls = {}, {}

    def pair(name, full, sharded, loops, **kw):
        """The sharded f32 solve of each loop beside the unsharded one, both
        from x0 None (a given zero start changes the f32 modes: the f32
        reduction and its floors apply from x0 None only): the same latch
        and steps, x within ``SHARD_F32_X`` of max|x| (heat M=1024, which
        runs to k at its floor, within max(``SHARD_F32_X``, 10x the JAX f32
        record's own drift))."""
        for loop in loops:
            key = f"{name}_{loop}"
            tag = f"[sharded f32 {key}]"
            run_u = lambda: cgmres(*full, loop=loop, **kw)  # noqa: E731
            run_s = lambda: cgmres(sharded[0], sharded[1], None,  # noqa: E731
                                   loop=loop, **{**kw, **sharded[3]})
            run_u()
            run_s()
            (xu, iu), wu = _median_walls(run_u, reps=3)
            (xsh, ish), wsh = _median_walls(run_s, reps=3)
            _reset_launches()
            run_s()
            torch.cuda.synchronize()
            launches = _read_launches()
            d = _rel(gather(xsh, mesh).double(), xu.double())
            print(f"{tag} steps {ish['steps']} (unsharded {iu['steps']}), "
                  f"safety {ish['safety']} ({iu['safety']}), deviation "
                  f"{ish['deviation']:.3e} ({iu['deviation']:.3e}), x "
                  f"against the unsharded f32 solve {d:.3e}; wall, median of"
                  f" 3: sharded {_med_ms(wsh):.3f} ms, unsharded "
                  f"{_med_ms(wu):.3f} ms; #1 windowed "
                  f"{launches['dia_spmv_window']}, mixed windowed "
                  f"{launches['dia_spmv_mixed_window']}, all_reduce "
                  f"{launches['all_reduce']}")
            _gate17(tag, launches)
            check(ish["safety"] == iu["safety"] is True,
                  f"{tag} safety {ish['safety']} vs {iu['safety']}")
            check(ish["steps"] == iu["steps"],
                  f"{tag} steps {ish['steps']} vs {iu['steps']}")
            check(d <= x_bar[name], f"{tag} x {d:.3e} from the unsharded "
                                    f"(bar {x_bar[name]:.3e})")
            check(launches["dia_spmv_window"] > 0
                  and launches["all_reduce"] > 0, f"{tag} launches")
            paths[key] = launches
            walls[key] = {"sharded_ms": _med_ms(wsh),
                          "unsharded_ms": _med_ms(wu), "steps": ish["steps"]}
            clear_core_cache()
        return launches

    tol = F32_SWE_RTOL * float(torch.linalg.norm(s.b.double()))
    pre = default_pre_builder("swe")(s)
    A, b, x0, cons = shard_system(s.A, s.b, torch.zeros_like(s.b),
                                  s.constraints(), mesh)
    opts = wrappers.reduction_mode(s, tol)
    pair(f"swe_M{SWE_M}_snc", (s.A, s.b, None),
         (A, b, x0, {"constraints": cons,
                     "pre": shard_preconditioner(pre, mesh)}),
         ("host", "while"), k=F32_K, tol=tol, constraints=s.constraints(),
         pre=pre, **opts)
    del A, b, x0, cons, pre
    torch.cuda.empty_cache()
    tol = F32_HEAT_RTOL * float(torch.linalg.norm(h.b.double()))
    hpre = default_pre_builder("heat")(h)
    hA, hb, hx0, hcons = shard_system(h.A, h.b, torch.zeros_like(h.b),
                                      h.constraints(), mesh)
    opts = wrappers.reduction_mode(h, tol)
    got = pair(f"heat_M{HEAT_M}_amg", (h.A, h.b, None),
               (hA, hb, hx0, {"constraints": hcons,
                              "pre": shard_preconditioner(hpre, mesh)}),
               ("while",), k=F32_K, tol=tol, constraints=h.constraints(),
               pre=hpre, **opts)
    check(got["dia_spmv_mixed_window"] > 0,
          f"[sharded f32 heat_M{HEAT_M}_amg] the energy matrix's "
          "certificates did not run the windowed mixed #1")
    del h, hpre, hA, hb, hx0, hcons
    torch.cuda.empty_cache()
    params = dict(M=SWE_M, N=3, T=0.3)
    s3 = swe.linforms(device=DEVICE, dtype=f32, **params)
    pre3 = default_pre_builder("swe")(s3)
    tol = F32_SWE_RTOL * float(torch.linalg.norm(s3.b.double()))
    runs = {}
    for key, m in (("unsharded", None), ("sharded", mesh)):
        fused_evolve("swe", k=F32_K, tol=tol, pre=pre3, mesh=m, dtype=f32,
                     device=DEVICE, **params)
        _reset_launches()
        runs[key] = fused_evolve("swe", k=F32_K, tol=tol, pre=pre3, mesh=m,
                                 dtype=f32, device=DEVICE, **params)
        torch.cuda.synchronize()
    fu, fs = runs["unsharded"], runs["sharded"]
    d = _rel(fs["sol"].double(), fu["sol"].double())
    tag = f"[sharded f32 swe_M{SWE_M}_fused_evolve]"
    print(f"{tag} steps {fs['steps'].tolist()} (unsharded "
          f"{fu['steps'].tolist()}), safety {fs['safety'].tolist()} "
          f"({fu['safety'].tolist()}), sol against the unsharded {d:.3e}")
    _gate17(tag, fs["timings"]["launches"])
    check(list(fs["steps"]) == list(fu["steps"])
          and all(int(v) == 1 for v in fs["safety"])
          and all(int(v) == 1 for v in fu["safety"]),
          f"{tag} steps or safety")
    check(d <= SHARD_F32_X, f"{tag} sol {d:.3e} from the unsharded")
    paths[f"swe_M{SWE_M}_fused_evolve_f32"] = fs["timings"]["launches"]
    walls["fused_evolve"] = {"steps": fs["steps"].tolist()}
    del s3, pre3, runs, fu, fs, s
    clear_core_cache()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print("[sharded f32] " + json.dumps({"window_mixed": win, "walls": walls,
                                         "seconds": secs}))
    print(f"[sharded f32] phase 31's f32 rows took {secs:.1f} s")
    return win, paths


# the eighteenth slice: CG on the device core (phase 34) and the
# convergence-order refinement on the card (phase 35)
CG_K, CG_TOL = 200, 1e-7
# the yardstick GMRES: its k; CG's x is held within CG_X_GMRES of max|x|
# to its solution at CG's tol and at CG_GMRES_REF_TOL (at CG's tol GMRES's
# own error is near the bar: 8.6e-7 of max|x| at heat M=1024 on the card)
CG_GMRES_K, CG_GMRES_REF_TOL, CG_X_GMRES = 60, 1e-10, 1e-6
ORDER = dict(M=120, degree=5, tol=1e-11)
ORDER_NS = (4, 8)
ORDER_EXACT_RTOL, ORDER_CGMRES_RTOL = 1e-9, 1e-6


def phase_cg(s):
    """CG on heat M=1024 (n = 1,050,625) with the structured AMG, on the
    system ``s`` of phases 20-23: ``cg(k=CG_K, tol=CG_TOL)`` on the host
    loop and on the device core (``solvers/cg.py::CgCore``, three graphs),
    held to each other (steps, residual trace, x), to tol and to the
    device-core GMRES's solution; the launches per ``cg_step`` replay and
    per solve; walls (medians of 5) beside the device-core GMRES at the
    same tol; busy and idle of one profiled device-core solve; then one f32
    solve of the row.  Returns the launches of one device-core solve and
    of the f32 one, and the phase's figures."""
    import importlib

    import numpy as np
    import torch

    from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_torch.solvers import gmres
    from structurepreservingiterativesolvers_torch.utils.cast import astype

    cgm = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cg")
    cores = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    tag = f"[heat_M{HEAT_M}_cg]"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = default_pre_builder("heat")(s)
    torch.cuda.synchronize()
    time_pre = time.perf_counter() - t0
    levels = sum(1 for L in pre.levels if L.P is not None)
    kw = dict(k=CG_K, tol=CG_TOL, pre=pre)

    def host():
        return cgm.cg(s.A, s.b, **kw)

    def device():
        return cgm.cg(s.A, s.b, loop="while", **kw)

    def yardstick():
        return gmres(s.A, s.b, k=CG_GMRES_K, tol=CG_TOL, pre=pre,
                     loop="while")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xw, iw = device()  # builds the core and captures its graphs
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    runner = cgm.last_core().runner
    before = dict(runner.replayed)
    _reset_launches()
    x2, i2 = device()
    torch.cuda.synchronize()
    launches = _read_launches()
    expected = _replayed(runner, before)
    per_replay = runner.launches()
    (xh, ih), host_walls = _timed(host)
    _, dev_walls = _timed(device)
    dp = _profiled(device)
    yardstick()  # its captures
    (xg, ig), g_walls = _timed(yardstick)
    xr, ir = gmres(s.A, s.b, k=CG_GMRES_K, tol=CG_GMRES_REF_TOL, pre=pre,
                   loop="while")
    true = float(torch.linalg.norm(s.b - s.A @ xw))
    hmed, dmed, gmed = (_median(w) for w in (host_walls, dev_walls, g_walls))
    trace = float(np.max(np.abs(iw["res"] - ih["res"]) / ih["res"]))
    print(f"{tag} AMG setup {time_pre:.4f} s ({levels + 1} levels); device "
          f"core: steps {iw['steps']}, residual trace "
          + ", ".join(f"{r:.3e}" for r in iw["res"])
          + f"; true residual {true:.4e} (tol {CG_TOL:g}); host loop steps "
          f"{ih['steps']}; trace {trace:.3e} relative and x "
          f"{_rel(xw, xh):.3e} from the host loop's; a second solve "
          f"bit-equal {bool(torch.equal(xw, x2))}; x {_rel(xw, xr):.3e} from "
          f"GMRES at tol {CG_GMRES_REF_TOL:g} ({ir['steps']} steps), "
          f"{_rel(xw, xg):.3e} from GMRES at tol {CG_TOL:g} ({ig['steps']} "
          f"steps)")
    print(f"{tag} wall, median of {GRAPH_SOLVES}: host loop {1e3 * hmed:.3f} "
          f"ms ({_ms(host_walls)}), device core {1e3 * dmed:.3f} ms "
          f"({_ms(dev_walls)}), device-core GMRES at the same tol "
          f"{1e3 * gmed:.3f} ms ({_ms(g_walls)}); first device-core solve "
          f"{1e3 * first:.1f} ms, time_capture {runner.time_capture:.3f} s "
          f"({runner.captures} graphs); profiled device-core solve: wall "
          f"{1e3 * dp[0]:.3f} ms, busy {dp[1]:.3f} ms, idle {dp[2]:.3f} "
          f"(busy over the unprofiled median: "
          f"{1.0 - dp[1] / 1e3 / dmed:.3f} idle)")
    print(f"{tag} launches over one device-core solve "
          f"{ {k: v for k, v in launches.items() if v} }; per replay by "
          f"graph {per_replay}")
    check(iw["steps"] == ih["steps"] == i2["steps"] < CG_K,
          f"{tag} steps {iw['steps']} (host loop {ih['steps']}, again "
          f"{i2['steps']})")
    check(trace <= 1e-10, f"{tag} residual trace {trace:.3e} from the host "
                          f"loop's")
    check(_rel(xw, xh) <= 1e-10, f"{tag} x {_rel(xw, xh):.3e} from the host "
                                 f"loop")
    check(torch.equal(xw, x2), f"{tag} a second replayed solve differs")
    check(math.isfinite(true) and true < CG_TOL and iw["res"][-1] < CG_TOL,
          f"{tag} true residual {true:.3e}")
    for xy, ty in ((xg, CG_TOL), (xr, CG_GMRES_REF_TOL)):
        check(_rel(xw, xy) <= CG_X_GMRES, f"{tag} x {_rel(xw, xy):.3e} from "
                                          f"the device-core GMRES at tol "
                                          f"{ty:g}")
    check(launches == expected, f"{tag} launches {launches} are not the "
                                f"replays' {expected}")
    step = per_replay.get("cg_step", {})
    check(step.get("stencil_spmv") == 1 and step.get("dia_spmv") == 7 * levels,
          f"{tag} a cg_step graph holds {step}, not one stencil product and "
          f"the V-cycle's {7 * levels} DIA products")
    for kernel in ("dia_spmv", "stencil_spmv"):
        _check_design(tag, launches, kernel, designs=HEAT_DESIGNS)
    kernels = sorted(nm for nm in dp[3] if "dia_spmv" in nm or "stencil" in nm)
    check(any("dia_spmv" in nm for nm in kernels)
          and any("stencil" in nm for nm in kernels),
          f"{tag} the profiler saw {kernels} in the device-core solve")

    # one f32 solve of the row, the system and the hierarchy cast
    tag32 = f"[heat_M{HEAT_M}_cg f32]"
    s32, p32 = astype(s, torch.float32), astype(pre, torch.float32)

    def device32():
        return cgm.cg(s32.A, s32.b, k=CG_K, tol=CG_TOL, pre=p32, loop="while")

    device32()  # its captures
    _reset_launches()
    (x32, i32), w32 = _timed(device32, reps=1)
    launches32 = _read_launches()
    xa, bh = x32.double().cpu().numpy(), s.b.cpu().numpy()
    true32 = float(np.linalg.norm(s.A_csr @ xa - bh))
    floor32 = float(np.finfo(np.float32).eps) * float(np.linalg.norm(
        abs(s.A_csr) @ np.abs(xa) + np.abs(bh)))
    print(f"{tag32} steps {i32['steps']} (f64 {iw['steps']}), residual "
          f"trace " + ", ".join(f"{r:.3e}" for r in i32["res"])
          + f" (the last the true residual in f32); in f64 at the f32 x "
          f"{true32:.3e}, against the f32 floor eps32·‖|A||x|+|b|‖ "
          f"{floor32:.3e} and tol {CG_TOL:g}; wall {1e3 * w32[0]:.3f} ms; x "
          f"{_rel(x32.double(), xw):.3e} from f64's; launches "
          f"{ {k: v for k, v in launches32.items() if v} }")
    check(abs(i32["steps"] - iw["steps"]) <= 2 and i32["steps"] < CG_K,
          f"{tag32} steps {i32['steps']} against f64's {iw['steps']}")
    check(true32 <= max(CG_TOL, floor32), f"{tag32} true residual "
                                          f"{true32:.3e} above the f32 floor "
                                          f"{floor32:.3e}")
    _gate17(tag32, launches32)
    del s32, p32
    cores.clear_core_cache()
    walls = {"host_ms": 1e3 * hmed, "device_core_ms": 1e3 * dmed,
             "gmres_device_core_ms": 1e3 * gmed, "first_ms": 1e3 * first,
             "capture_s": runner.time_capture, "busy_ms": dp[1],
             "idle": dp[2], "steps": iw["steps"], "gmres_steps": ig["steps"],
             "f32_ms": 1e3 * w32[0], "f32_steps": i32["steps"],
             "f32_true_residual": true32, "f32_floor": floor32,
             "time_pre_s": time_pre, "cg_step_launches": step}
    return launches, launches32, walls


def _order_script():
    """``scripts/run_error_order_torch.py`` as a module: the study's own
    evolution (``final_error``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_error_order_torch", ROOT / "scripts" / "run_error_order_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_order(record):
    """The s=1 dt-refinement of the convergence-order study at degree 5,
    M=120, N = 4 and 8, tol=1e-11, every CGMRES step on the device core:
    the observed order within 0.4 of 2 for Exact and CGMRES, CGMRES ≤ 1.05
    × Exact at both levels, each error within ``ORDER_EXACT_RTOL`` /
    ``ORDER_CGMRES_RTOL`` of the JAX record (``reference/slice18.json``).
    Returns the launches of the CGMRES evolutions and the figures."""
    import torch

    study = _order_script()
    rec = record["order_deg5_s1_M120"]["runs"]
    tag = "[order]"
    errs, walls, launches = {}, {}, {}
    for solver in ("Exact", "CGMRES"):
        _reset_launches()
        for N in ORDER_NS:
            key = f"{solver}_N{N}"
            t0 = time.perf_counter()
            e, out = study.final_error(solver, N, 1, loop="while",
                                       device=DEVICE, **ORDER)
            torch.cuda.synchronize()
            walls[key], errs[key] = time.perf_counter() - t0, e
            ref = rec[key]["err"][-1]
            print(f"{tag} {solver} N={N}: err(T) {e:.9e} (JAX record "
                  f"{ref:.9e}, {abs(e - ref) / ref:.2e} relative), solver "
                  f"steps {list(out['steps'])}, wall {walls[key]:.2f} s")
            rtol = ORDER_EXACT_RTOL if solver == "Exact" else ORDER_CGMRES_RTOL
            check(abs(e - ref) <= rtol * ref, f"{tag} {key} err(T) {e:.9e} "
                                              f"against the record's {ref:.9e}")
        if solver == "CGMRES":
            launches = _read_launches()
    orders = {solver: math.log2(errs[f"{solver}_N4"] / errs[f"{solver}_N8"])
              for solver in ("Exact", "CGMRES")}
    ratios = [errs[f"CGMRES_N{N}"] / errs[f"Exact_N{N}"] for N in ORDER_NS]
    print(f"{tag} observed orders {orders} (expected 2), CGMRES/Exact "
          f"{ratios}; launches over the CGMRES evolutions "
          f"{ {k: v for k, v in launches.items() if v} }")
    for solver, order in orders.items():
        check(abs(order - 2.0) < 0.4, f"{tag} {solver} order {order:.4f}")
    check(max(ratios) < 1.05, f"{tag} CGMRES/Exact {ratios}")
    check(launches["dia_spmv"] > 0, f"{tag} the CGMRES evolutions launched "
                                    f"no kernel #1")
    return launches, {"errors": errs, "orders": orders, "ratios": ratios,
                      "walls_s": walls}


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
                            "slice9.json", "slice15.json", "slice17.json",
                            "slice18.json")}
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
    kept = {}
    rk_rows = phase_lkdvrk_rows(records["slice7.json"], keep=kept)
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
    # the twelfth slice: lkdvRK under the graph core (phases 24-27), on the
    # systems and preconditioners of phase 14; #1 on the operators these
    # paths add, #1b on every (operator, width) each path gave it
    shapes.checks()
    gen12 = torch.Generator(device=DEVICE).manual_seed(13)
    for name, (s12, _) in kept.items():
        dia_rk_err = max(dia_rk_err, _check_dia(f"{name} Mmat", s12.Mmat,
                                                gen12))
    s32, pre32 = kept[LKDVRK_ROWS[0]]
    dia_rk_err = max(dia_rk_err, _check_dia(f"{LKDVRK_ROWS[0]} Gmat",
                                            s32.Gmat, gen12))
    shapes.path("lkdvrk_graph_core", keep=True)
    rk12, rk12_walls = phase_lkdvrk_graph(records["slice7.json"], kept)
    torch.cuda.synchronize()
    shapes.checks()
    spmm_err = max(spmm_err, _check_path_spmm_any(shapes, "lkdvrk_graph_core",
                                                  gen12))
    shapes.path(f"{LKDVRK_ROWS[0]}_fused_evolve", keep=True)
    paths, rk12_walls["fused_evolve"] = phase_lkdvrk_fused_evolve(
        records["slice7.json"], s32, pre32)
    rk12.update(paths)
    torch.cuda.synchronize()
    shapes.checks()
    spmm_err = max(spmm_err, _check_path_spmm_any(
        shapes, f"{LKDVRK_ROWS[0]}_fused_evolve", gen12))
    shapes.path("lkdvrk_B8", keep=True)
    rk_batch = phase_lkdvrk_batched(records["slice7.json"], kept)
    rk12.update({name: row["launches"] for name, row in rk_batch.items()})
    torch.cuda.synchronize()
    shapes.checks()
    spmm_err = max(spmm_err, _check_path_spmm_any(shapes, "lkdvrk_B8", gen12))
    # the f64 systems and composites phase 33 casts to f32
    rk17 = {name: kept[name] for name in RK17}
    del kept, s32, pre32, s12
    torch.cuda.empty_cache()
    shapes.path("lkdv_hard_graph_core", keep=True)
    rk12.update(phase_lkdv_core_extras())
    torch.cuda.synchronize()
    shapes.checks()
    spmm_err = max(spmm_err, _check_path_spmm_any(
        shapes, "lkdv_hard_graph_core", gen12))
    err9, swe_spmm, batch_rows = phase_batched(records["slice9.json"], shapes)
    spmm_err = max(spmm_err, err9)
    torch.cuda.synchronize()
    # the eleventh slice: heat on the device core
    t0 = time.perf_counter()
    heat_sys = heat.linforms(M=HEAT_M, device=DEVICE)
    print(f"[heat M={HEAT_M}] assembly {time.perf_counter() - t0:.2f} s")
    block_err, block_times = phase_block_kernels(heat_sys)
    torch.cuda.synchronize()
    # #1b on every operator and width of each of these paths, after it
    gen11 = torch.Generator(device=DEVICE).manual_seed(12)
    shapes.path(f"heat_M{HEAT_M}_graph_core", keep=True)
    heat11, heat11_walls = phase_heat_graph(records["slice2.json"],
                                            records["slice3.json"])
    torch.cuda.synchronize()
    shapes.checks()
    spmm_err = max(spmm_err, _check_path_spmm(
        shapes, f"heat_M{HEAT_M}_graph_core", gen11)[0])
    shapes.path(f"heat_M{HEAT_M}_fused_evolve", keep=True)
    paths, heat11_walls["fused_evolve"] = phase_heat_fused_evolve(heat_sys)
    heat11.update(paths)
    torch.cuda.synchronize()
    shapes.checks()
    spmm_err = max(spmm_err, _check_path_spmm(
        shapes, f"heat_M{HEAT_M}_fused_evolve", gen11)[0])
    heat_rows = {}
    for name, *_ in HEAT_BATCH_ROWS:
        shapes.path(name, keep=True)
        heat_rows.update(phase_heat_batched(heat_sys, name))
        torch.cuda.synchronize()
        shapes.checks()
        spmm_err = max(spmm_err, _check_path_spmm(shapes, name, gen11)[0])
        for kernel, err in heat_rows[name]["errs"].items():
            block_err[kernel] = max(block_err[kernel], err)
    # heat_sys stays for phase 34
    heat11.update({name: row["launches"] for name, row in heat_rows.items()})
    # the thirteenth slice: heat P2 with the greedy host AMG (phases 28-30)
    torch.cuda.empty_cache()
    p2_sys, p2_pre, p2 = phase_heat_p2()
    torch.cuda.synchronize()
    p2_batch, p2["walls"]["batched"], err13 = phase_heat_p2_batched(
        p2_sys, p2_pre, shapes)
    spmm_err = max(spmm_err, err13)
    ortho_times[f"{P2}_m{p2['ortho_m']}"] = _time_ortho(
        f"{P2}_m{p2['ortho_m']}", P2_N, p2["ortho_m"],
        torch.Generator(device=DEVICE).manual_seed(30))
    p2_paths = {**p2["paths"], f"{P2}_amg_B{P2_B}": p2_batch}
    # heat P2 M=512's f64 system and hierarchy, which phase 33 casts to f32
    p2_keep = (p2_sys, p2_pre)
    del p2_sys, p2_pre
    torch.cuda.empty_cache()
    anchor_paths, err_a, times_a, err_b, spmm_a = phase_heat_p2_dia_anchor(
        shapes)
    p2_paths.update(anchor_paths)
    p2["dia_err"] = max(p2["dia_err"], err_a)
    p2["dia_times"].update(times_a)
    spmm_err = max(spmm_err, err_b)
    spmm_times.update(spmm_a)
    torch.cuda.synchronize()
    phase_native()
    torch.cuda.synchronize()
    # the fourteenth slice: the row-sharded path (phase 31)
    win, shard_paths, (win17, shard17_paths) = phase_sharded()
    import torch.distributed as dist

    dist.destroy_process_group()
    # the fifteenth slice: f32 storage (phase 32)
    torch.cuda.empty_cache()
    f32_times, mixed_entry, f32_paths = phase_f32(records["slice15.json"])
    # the seventeenth slice: f32 on lkdvRK, general constraints, heat P2,
    # the sweep and the batch (phase 33)
    torch.cuda.empty_cache()
    f17_times, f17_errs, f17_paths = phase_f32_rest(
        records["slice7.json"], records["slice17.json"], rk17, p2_keep)
    del rk17, p2_keep
    f32_paths.update(f17_paths)
    f32_paths.update({f"sharded_{k}": v for k, v in shard17_paths.items()})
    # the eighteenth slice: CG on the device core on phase 20's heat M=1024
    # system (phase 34) and the convergence-order refinement (phase 35)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cg_launches, f32_paths[f"heat_M{HEAT_M}_cg_f32"], cg18 = phase_cg(heat_sys)
    del heat_sys
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    t0 = time.perf_counter()
    order_launches, order18 = phase_order(records["slice18.json"])
    t_order = time.perf_counter() - t0
    print(f"[env] phase 34 took {t_cg:.1f} s, phase 35 {t_order:.1f} s")
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
                "lkdv_hard_general": general_launches, **rk12, **p2_paths}

    def by_path(name, **first):
        """A kernel's launches on each path that ran it."""
        paths = {**first, **{row: rows[row][name] for row in rows},
                 **{a: anchors[a][name] for a in anchors},
                 **{path: n[name] for path, n in heat11.items()}}
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
         "max_abs_err": max(dia_err, dia_heat_err, dia_rk_err, p2["dia_err"]),
         "timed_at": f"heat_M{HEAT_M}_A", **dia,
         "times": {f"swe_M{SWE_M}_A": dia_swe, f"heat_M{HEAT_M}_A": dia,
                   f"{LKDVRK_ROWS[0]}_A": dia_rk, **p2["dia_times"]}},
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
             "ms", "chain_ms", "bound_ms", "warm_ms", "warm_chain_ms",
             "plan")}
             for label, t in ortho_times.items()}})
    # the batched kernel's launches on every path that ran it: the batched
    # rows, and the catch-up's products with a DIA constraint matrix
    # (heat's Emat, lkdv's and lkdvRK's mass matrix) and the general
    # constraint's vmapped products on the host loop and the device core
    spmm_paths = {**{name: row["launches"] for name, row in batch_rows.items()},
                  f"heat_M{HEAT_M}": launches, **lkdv_launches, **rk_paths,
                  **rows, **anchors, **heat11}
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
    # the block forms of kernels #2, #3 and #4 on the batched heat rows
    for name, source, line, single in (
            ("stencil_spmm", "stencil_spmv.cu", "pallas_spmv.py:165",
             "stencil_spmv"),
            ("cheb_apply_many", "poly_tiled.cu", "pallas_poly.py:217",
             "cheb_apply"),
            ("neumann_apply_many", "poly_tiled.cu", "pallas_poly.py:230",
             "neumann_apply")):
        t = block_times[name]
        entry = {"name": name, "route": "cuda", "source": src + source,
                 "replaces": f"{tpu}{line}",
                 "replaces_under": "structurepreservingiterativesolvers_tpu/"
                                   "experiments/batched.py:87 (jax.vmap)",
                 "block_form_of": single,
                 "launches": sum(n[name] for n in heat11.values()),
                 "launches_by_path": {path: n[name]
                                      for path, n in heat11.items() if n[name]},
                 "launches_by_design": {
                     design: sum(n[f"{name}_{design}"] for n in heat11.values())
                     for design in ("tiled", "flat")},
                 "max_abs_err": block_err[name], "timed_at":
                     f"heat_M{HEAT_M}_B{HEAT_B}",
                 **{key: t[key] for key in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                 "times": t}
        if source != "stencil_spmv.cu":
            entry["flat_source"] = src + "poly_apply.cu"
        kernels.append(entry)
    # kernel #1's windowed launch on the sharded paths (#1b's beside it)
    by_name = {k["name"]: k for k in kernels}
    by_name["dia_spmv"]["launches_by_path"].update({
        f"sharded_{path}": n["dia_spmv"] for path, n in shard_paths.items()
        if n.get("dia_spmv")})
    by_name["dia_spmv"]["launches_by_path"].update({
        f"heat_M{HEAT_M}_cg": cg_launches["dia_spmv"],
        "lkdvrk_order_deg5_s1_M120": order_launches["dia_spmv"]})
    by_name["stencil_spmv"]["launches_by_path"][f"heat_M{HEAT_M}_cg"] = (
        cg_launches["stencil_spmv"])
    by_name["fused_update_matvec"]["launches_by_path"].update({
        f"sharded_{path}": n["fused_update_matvec"]
        for path, n in shard_paths.items() if n.get("fused_update_matvec")})
    kernels.append(
        {"name": "dia_spmv_window", "route": "cuda",
         "source": src + "dia_spmv.cu", "block_source": src + "dia_spmm.cu",
         "replaces": f"{tpu}pallas_spmv.py:91",
         "launch_of": "dia_spmv",
         "launches": sum(n.get("dia_spmv_window", 0)
                         for n in shard_paths.values()),
         "launches_by_path": {path: n["dia_spmv_window"]
                              for path, n in shard_paths.items()
                              if n.get("dia_spmv_window")},
         "block_launches_by_path": {path: n["dia_spmm_window"]
                                    for path, n in shard_paths.items()
                                    if n.get("dia_spmm_window")},
         "max_abs_err": win["max_abs_err"], "timed_at": f"swe_M{SWE_M}_A",
         **{key: win[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
         "times": win})
    # the f32 instantiations' times beside each kernel's f64 entry, their
    # launches on the f32 paths, and the mixed #1's own entry
    for name, labels in (
            ("dia_spmv", (f"dia_spmv_swe M={SWE_M} A",
                          f"dia_spmv_heat M={HEAT_M} A (DIA)")),
            ("dia_spmm", (f"dia_spmm_swe M={SWE_M} A B=8",)),
            ("stencil_spmv", (f"stencil_spmv_heat M={HEAT_M}",)),
            ("stencil_spmm", (f"stencil_spmm_heat M={HEAT_M} B=8",)),
            ("fused_update_matvec",
             (f"fused_update_matvec_swe M={SWE_M} m=21",))):
        by_name[name]["f32"] = {label: f32_times[label] for label in labels}
    # phase 33's shapes beside them
    for name in ("dia_spmv", "dia_spmm", "fused_update_matvec"):
        by_name[name]["f32"].update({label: t for label, t in f17_times.items()
                                     if label.startswith(name)})
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"],
                                           f17_errs[name])
    for name in ("dia_spmv", "dia_spmm", "stencil_spmv", "stencil_spmm",
                 "cheb_apply", "neumann_apply", "fused_update_matvec"):
        by_name[name]["f32_launches_by_path"] = {
            path: n[f"{name}_f32"] for path, n in f32_paths.items()
            if n.get(f"{name}_f32")}
    mixed_entry["times"].update({k: v for k, v in f17_times.items()
                                 if k.startswith("mixed_")})
    mixed_entry["max_abs_err"] = max(mixed_entry["max_abs_err"],
                                     f17_errs["dia_spmv_mixed"])
    mixed_entry["launches_by_path"] = {
        path: n["dia_spmv_mixed"] for path, n in f32_paths.items()
        if n.get("dia_spmv_mixed")}
    mixed_entry["launches"] = sum(mixed_entry["launches_by_path"].values())
    kernels.append(mixed_entry)
    # the mixed #1's windowed launch on the sharded f32 paths (row "1m w")
    head = f"heat M={HEAT_M} Emat"
    kernels.append(
        {"name": "dia_spmv_mixed_window", "route": "cuda",
         "source": src + "dia_spmv.cu",
         "replaces": "structurepreservingiterativesolvers_tpu/ops/dd.py:213",
         "replaces_note": "ops/dd.py::spmv_dia on a row-sharded operator "
                          "(GSPMD partitions it in the JAX package)",
         "launch_of": "dia_spmv_mixed",
         "launches": sum(n.get("dia_spmv_mixed_window", 0)
                         for n in shard17_paths.values()),
         "launches_by_path": {path: n["dia_spmv_mixed_window"]
                              for path, n in shard17_paths.items()
                              if n.get("dia_spmv_mixed_window")},
         "max_abs_err": win17["max_abs_err"], "timed_at": head,
         **{key: win17[head][key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
         "times": {k: v for k, v in win17.items() if k != "max_abs_err"}})
    print("[heat11] " + json.dumps({"walls": heat11_walls, "batched": {
        name: {key: row[key] for key in ("wall_ms", "single_ms", "capture_s",
                                         "idle")}
        for name, row in heat_rows.items()}}))
    print("[lkdvrk] " + json.dumps({name: {
        key: row[key] for key in ("format", "width", "ras_blocks", "time_pre",
                                  "time_pre_first", "runtime", "time_gmres",
                                  "cgmres_over_gmres", "wall", "composite")}
        for name, row in rk_rows.items()}))
    print("[heat_p2] " + json.dumps(p2["walls"]))
    print("[lkdvrk12] " + json.dumps({"walls": rk12_walls, "batched": {
        name: {key: row[key] for key in ("wall_ms", "single_ms", "capture_s",
                                         "idle", "busy_ms")}
        for name, row in rk_batch.items()}}))
    print("[cg18] " + json.dumps({"cg": cg18, "order": order18,
                                  "phase_s": {"34": t_cg, "35": t_order}}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
