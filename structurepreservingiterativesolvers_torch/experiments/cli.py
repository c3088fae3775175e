"""Command-line interface of the port.  The solves run on the card unless
``--device`` says otherwise::

    python -m structurepreservingiterativesolvers_torch single --problem lkdv --k 20
    python -m structurepreservingiterativesolvers_torch single --problem swe --M 64 --k 60 --tol 1e-9
    python -m structurepreservingiterativesolvers_torch timed --problem heat --sizes 1024
    python -m structurepreservingiterativesolvers_torch timed --problem heat --sizes 16 32 --device cpu
    python -m structurepreservingiterativesolvers_torch timed --problem heat --sizes 1024 --loop while
    python -m structurepreservingiterativesolvers_torch timed --problem swe --sizes 512 --ortho cgs2_fused
    python -m structurepreservingiterativesolvers_torch evolve --problem swe --M 16 --N 5 --tol 1e-6 --k 30 --device cpu
    python -m structurepreservingiterativesolvers_torch evolve --problem lkdvrk --M 20 --N 10 --tol 1e-8 --device cpu
    python -m structurepreservingiterativesolvers_torch timed --problem lkdv --sizes 50 100 --device cpu
    python -m structurepreservingiterativesolvers_torch sweep --M 400 --N 10
    python -m structurepreservingiterativesolvers_torch sweep --M 50 --N 3 --device cpu
    python -m structurepreservingiterativesolvers_torch timed --problem lkdvrk --sizes 50 --loop while --device cpu
    python -m structurepreservingiterativesolvers_torch sweep --M 50 --N 3 --loop while --device cpu
    python -m structurepreservingiterativesolvers_torch sweep --M 50 --N 3 --dtype float32 --device cpu
    python -m structurepreservingiterativesolvers_torch timed --problem heat --degree 2 --sizes 16 32 --k 60 --device cpu
    python -m structurepreservingiterativesolvers_torch single --problem lkdv --M 20 --plot --device cpu
    python -m structurepreservingiterativesolvers_torch evolve --problem lkdv --M 20 --N 5 --plot --device cpu
    python -m structurepreservingiterativesolvers_torch dist-bench --spawn 2 --problem swe --M 16 --device cpu
    python -m structurepreservingiterativesolvers_torch timed --problem swe --sizes 16 32 --tol 4e-7 --tol-mode rhs --dtype float32 --device cpu

``--ortho`` picks the Arnoldi orthogonalisation of both solvers: ``cgs2``
(the default), ``cgs2_fused`` (its middle pair through the fused CGS2
kernel on the card) or ``mgs``.  ``timed --loop while`` and ``sweep --loop
while`` run the solvers on the device core, the JAX package's default
loop.  ``single --plot`` tabulates both solvers and draws the convergence
figure, ``evolve --plot`` runs GMRES and CGMRES evolutions and draws their
drifts (``plots/``; pandas and matplotlib needed then only).
``--dtype float32`` (``single``, ``timed``, ``evolve``, ``sweep``) stores the vectors
in f32, the JAX package's TPU mode (its ``SPIS_FORCE_DTYPE``): the models'
``dtype=``, the solvers' f32 modes (``solvers/cgmres.py::resolve_modes``).
``dist-bench`` is one process of a row-sharded benchmark job (the
``SPIS_COORDINATOR``, ``SPIS_NUM_PROCESSES`` and ``SPIS_PROCESS_ID``
variables say which), or, with ``--spawn N``, spawns local jobs of 1 and N
processes (one device each: gloo ranks with ``--device cpu``, one card
each with ``--device cuda``) and prints their scaling-efficiency table.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(prog="structurepreservingiterativesolvers_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device to solve on (default cuda)")
        p.add_argument("--dtype", default="float64",
                       choices=["float64", "float32"],
                       help="storage dtype of the vectors (default float64; "
                            "float32: the f32 storage mode)")
        p.add_argument("--ortho", default="cgs2",
                       choices=["cgs2", "cgs2_fused", "mgs"],
                       help="Arnoldi orthogonalisation (default cgs2)")

    problems = ["lkdv", "lkdvrk", "swe", "heat"]

    p = sub.add_parser("single", help="one-step solver comparison (SingleSolve)")
    p.add_argument("--problem", default="lkdv", choices=problems)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-50)
    p.add_argument("--M", type=int, default=50)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--plot", action="store_true",
                   help="tabulate and plot (needs pandas and matplotlib)")
    device_arg(p)

    p = sub.add_parser("timed", help="TimedSolve size sweep with the "
                                     "problem's default preconditioner")
    p.add_argument("--problem", default="heat", choices=problems)
    p.add_argument("--sizes", type=int, nargs="+", default=None)
    p.add_argument("--degree", type=int, default=1,
                   help="finite-element degree (heat 2: P2, greedy AMG)")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--tol-mode", default="abs", choices=["abs", "rhs"])
    p.add_argument("--loop", default="host", choices=["host", "while"],
                   help="both solvers' loop: host (default) or while, the "
                        "device core (CUDA graphs on the card)")
    device_arg(p)

    p = sub.add_parser("evolve", help="time evolution with drift tracking "
                                      "(CGMRES, unpreconditioned)")
    p.add_argument("--problem", default="lkdv", choices=problems)
    p.add_argument("--N", type=int, default=100)
    p.add_argument("--M", type=int, default=50)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--plot", action="store_true",
                   help="GMRES against CGMRES drifts, plotted (needs "
                        "matplotlib)")
    device_arg(p)

    p = sub.add_parser("sweep", help="lkdvRK convergence-order error sweep "
                                     "(the reference's grid)")
    p.add_argument("--parallel", action="store_true",
                   help="one worker process per run")
    p.add_argument("--N", type=int, default=10)
    p.add_argument("--M", type=int, default=400)
    p.add_argument("--plot", action="store_true",
                   help="plot the errors (needs matplotlib)")
    p.add_argument("--loop", default="host", choices=["host", "while"],
                   help="the solvers' loop: host (default) or while, the "
                        "device core (CUDA graphs on the card)")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default cuda)")
    p.add_argument("--dtype", default="float64",
                   choices=["float64", "float32"],
                   help="storage dtype of the vectors (default float64; "
                        "float32: the f32 storage mode)")

    p = sub.add_parser(
        "dist-bench",
        help="row-sharded benchmark: one process of a job (env "
             "SPIS_COORDINATOR/SPIS_NUM_PROCESSES/SPIS_PROCESS_ID), or "
             "--spawn N to run local jobs of 1 and N processes and print the "
             "scaling-efficiency table")
    p.add_argument("--problem", default="swe",
                   choices=["lkdv", "lkdvrk", "heat", "swe"])
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--spawn", type=int, default=None, metavar="N",
                   help="spawn jobs with 1 and N processes locally, one "
                        "device each, and print the efficiency table")
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, one card a process) or cpu (gloo)")

    args = parser.parse_args(argv)
    if args.cmd in ("single", "timed", "evolve"):
        import torch

        dtype = getattr(torch, args.dtype)

    if args.cmd == "single":
        from .single_solve import single_solve

        single_solve(args.problem, k=args.k, tol=args.tol, M=args.M,
                     degree=args.degree, plot=args.plot, device=args.device,
                     ortho=args.ortho, dtype=dtype)
    elif args.cmd == "timed":
        from .timed_solve import timed_solve

        timed_solve(args.problem, sizes=args.sizes, degree=args.degree,
                    tol=args.tol, k=args.k, tol_mode=args.tol_mode,
                    device=args.device,
                    ortho=args.ortho, loop=args.loop, dtype=dtype)
    elif args.cmd == "evolve":
        import functools

        from . import wrappers
        from .evolve import deviation_plotter, evolve

        if args.plot:
            deviation_plotter(args.problem, tol=args.tol, N=args.N, M=args.M,
                              degree=args.degree, k=args.k,
                              device=args.device, dtype=dtype)
        else:
            out = evolve(args.problem, N=args.N, M=args.M,
                         degree=args.degree, k=args.k, tol=args.tol,
                         device=args.device, dtype=dtype,
                         solver=functools.partial(wrappers.cgmres_wrapper,
                                                  ortho=args.ortho))
            for key in ("dm", "dmo", "de"):
                if key in out:
                    print(f"final {key}: {out[key][-1]:.3e}")
    elif args.cmd == "sweep":
        import torch

        from .error_sweep import error_plot, run_sweep

        dtype = getattr(torch, args.dtype)
        merged = run_sweep(parallel=args.parallel, N=args.N, M=args.M,
                           loop=args.loop, dtype=dtype, device=args.device)
        for run in merged:
            print(f"{run['solver']} q={run['degree']} s={run['tstages']}: "
                  f"final err {run['err'][-1]:.6e}, dm {run['dm'][-1]:.3e}, "
                  f"de {run['de'][-1]:.3e}")
        if args.plot:
            error_plot(dtype=dtype)
    elif args.cmd == "dist-bench":
        if args.spawn:
            from .scaling import dist_efficiency

            dist_efficiency(args.problem, M=args.M, k=args.k, tol=args.tol,
                            process_counts=sorted({1, args.spawn}),
                            device=args.device)
        else:
            import torch.distributed as dist

            from .scaling import dist_bench_worker

            dist_bench_worker(args.problem, M=args.M, k=args.k, tol=args.tol,
                              device=args.device)
            # the ranks leave the group together: a process that exits with
            # its group alive can abort there (gloo, "terminate called
            # without an active exception")
            dist.barrier()
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
