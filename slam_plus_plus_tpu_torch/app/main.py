"""Batch CLI of the port (the batch paths of slam_plus_plus_tpu/app/main.py,
reference src/slam_app/Main.cpp:41).

    python -m slam_plus_plus_tpu_torch.app.main -i file.g2o [-po] [-lm | -dl]
        [-v] [-s] [-mfnsi N] [-fnset X] [--device cuda|cpu]

  -i <file>      input dataset (g2o dialect: mono, intrinsics, stereo and
                 spheron BA; SE(2) and SE(3) pose graphs and landmarks)
  -po            pose-only (expect no landmarks; informational)
  -lm, -,\\lm    Lambda-LM; the default is LM for BA datasets and GN
                 (Lambda) otherwise, as the reference (Main.cpp:205-210)
  -dl, -,\\dl    Lambda-DL, the dogleg trust-region solver
  -mfnsi <N>     max final-optimization iterations     (default 5)
  -fnset <e>     final-optimization dx threshold       (default 0.01)
  -s / -v        silent / verbose
  --device       cuda (default; float32) or cpu (float64).  There is no
                 fallback: cuda without a card is an error.

The printed lines match the JAX CLI's: ``initial denormalized chi2 error``
(with -v), ``solver took N iterations`` and ``denormalized chi2 error``.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(
        prog="slam_plus_plus_tpu_torch",
        description="batch sparse nonlinear least squares (SLAM / BA) on PyTorch/CUDA")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-po", "--pose-only", action="store_true")
    p.add_argument("-lm", "-,\\lm", dest="solver", action="store_const",
                   const="lambda_lm")
    p.add_argument("-dl", "-,\\dl", dest="solver", action="store_const",
                   const="lambda_dl")
    p.add_argument("-mfnsi", type=int, default=5)
    p.add_argument("-fnset", type=float, default=0.01)
    p.add_argument("-s", "--silent", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def run(args):
    """Parse, solve (GN, Lambda-LM or Lambda-DL), print the reference CLI's
    lines.  Returns (final chi2, iterations, the solver)."""
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o, peek_dataset
    from slam_plus_plus_tpu_torch.solvers.dogleg import DoglegSolver
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
    from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

    flags = peek_dataset(args.input)
    is_ba = flags["has_ba"] or flags["has_stereo"] or flags["has_spheron"]
    if not args.silent:
        fam = [k for k, v in flags.items() if v]
        print(f"dataset: {args.input} ({', '.join(fam) or 'unknown'})")
    t0 = time.perf_counter()
    system = parse_g2o(args.input)
    if not args.silent:
        print(f"parsed {system.num_vertices} vertices, {system.num_edges} "
              f"edges in {time.perf_counter() - t0:.3f}s")

    t0 = time.perf_counter()
    kind = args.solver or ("lambda_lm" if is_ba else "lambda")
    cls = {"lambda_lm": LevenbergMarquardtSolver, "lambda_dl": DoglegSolver,
           "lambda": GaussNewtonSolver}[kind]
    solver = cls(system, device=args.device)
    if args.verbose:
        print(f"initial denormalized chi2 error: {solver.chi2():.2f}")
    chi2, iters = solver.optimize(args.mfnsi, args.fnset, verbose=args.verbose)
    print(f"done. it took {time.perf_counter() - t0:.5f} sec")
    print(f"solver took {iters} iterations")
    print(f"denormalized chi2 error: {chi2:.2f}")
    return chi2, iters, solver


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch sees no CUDA device; "
              "run on a GPU or pass --device cpu", file=sys.stderr)
        return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
