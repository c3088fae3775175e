"""Command-line interface of the port.  So far it has one subcommand::

    python -m structurepreservingiterativesolvers_torch single --problem lkdv --k 20 --device cuda
    python -m structurepreservingiterativesolvers_torch single --problem swe --M 64 --k 60 --tol 1e-9 --device cuda
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(prog="structurepreservingiterativesolvers_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("single", help="one-step solver comparison (SingleSolve)")
    p.add_argument("--problem", default="lkdv", choices=["lkdv", "swe"])
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-50)
    p.add_argument("--M", type=int, default=50)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--device", required=True,
                   help="torch device to solve on, e.g. cuda or cpu")

    args = parser.parse_args(argv)

    if args.cmd == "single":
        from .single_solve import single_solve

        single_solve(args.problem, k=args.k, tol=args.tol, M=args.M,
                     degree=args.degree, device=args.device)


if __name__ == "__main__":
    main()
