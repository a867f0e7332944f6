"""CLI of the port (the batch and incremental paths of
slam_plus_plus_tpu/app/main.py, reference src/slam_app/Main.cpp:41).

    python -m slam_plus_plus_tpu_torch.app.main -i file.g2o [-po] [-A | -lm | -dl]
        [-nsp N | -lsp N] [-fL] [-mnsi N] [-nset X]
        [-v] [-s] [-mfnsi N] [-fnset X] [-us] [-nb] [-dx FILE] [-gt FILE]
        [--rpe-delta N] [-dm] [-dsi DIR] [--device cuda|cpu] [--native]
        [--dist-coord HOST:PORT --dist-nprocs N --dist-procid I]
    python -m slam_plus_plus_tpu_torch.app.main -rmut | -rmb NAME TYPE [--device cuda|cpu]

  -i <file>      input dataset (g2o dialect: mono, intrinsics, stereo and
                 spheron BA; SE(2) and SE(3) pose graphs and landmarks; ROCV)
  -po            pose-only (expect no landmarks; informational)
  -nsp <N>       incremental: nonlinear solve every N vertices
  -lsp <N>       incremental: linear solve every N vertices (one iteration,
                 always pushed)
  -fL, -L        with -nsp / -lsp, FastL: the maintained factor with omega
                 updates (solvers/fastl.py); without them the batch solve
  --native       with -nsp / -lsp and --device cpu: the replay runs in the
                 C++ engine (solvers/native_engine.py; SE(2) and 2D-landmark
                 graphs); any other case is an error, never the torch engine
  -mnsi <N>      max nonlinear-solve iterations        (default 10)
  -nset <e>      nonlinear-solve dx threshold          (default 20)
  -A             the A solver: GN over the rectangular Jacobian, solved by
                 LSQR on the host (solvers/a_solver.py)
  -lm, -,\\lm    Lambda-LM; the default is LM for BA datasets and GN
                 (Lambda) otherwise, as the reference (Main.cpp:205-210)
  -dl, -,\\dl    Lambda-DL, the dogleg trust-region solver
  -mfnsi <N>     max final-optimization iterations     (default 5)
  -fnset <e>     final-optimization dx threshold       (default 0.01)
  -us            use the Schur complement (accepted; the solvers pick it
                 for landmark problems by themselves, as the JAX CLI's do)
  -nb            no bitmaps; without it the solution is drawn into
                 solution.png (app/plot.py, which needs matplotlib and
                 draws nothing without it, as the JAX CLI's)
  -dx <file>     write the solution (default solution.txt; '' disables)
  -gt <file>     ground truth (g2o vertex lines or a solution file): print
                 ATE and RPE after the solve; --rpe-delta sets RPE's step
  -dm            after the solve, the marginal covariances of the solution
                 (marginals/covariance.py, float64 on either device): print
                 the mean pose sigma
  -dsi <dir>     incremental: write solution_NNNNN.txt into dir after every
                 step of the replay (reference -iBAsi); the incremental
                 lambda solver then takes its own path, as the JAX CLI's
                 dumps turn its fused path off.  With -fL the directory is
                 made and nothing is dumped, as in the JAX CLI
  -s / -v        silent / verbose; -v also prints the memory line (host
                 RSS and, on a card, its allocator's use and peak)
  -rmut          the block-matrix unit tests (app/block_unit.py), then exit
  -rmb NAME TYPE the block-matrix benchmark sheet (TYPE: alloc, factor or
                 all), then exit; both run on --device, before any parse
  --device       cuda (default; float32 Schur-route batch solvers, float64
                 pose-graph GN / LM and incremental ones) or cpu (float64).
                 There is no fallback: cuda without a card is an error.
  --dist-coord HOST:PORT, --dist-nprocs N, --dist-procid I
                 join a multi-process run (parallel/multihost.py; the
                 coordinator may also be a file:// path, and the SLAMPP_COORD
                 / SLAMPP_NPROCS / SLAMPP_PROC_ID variables stand in for the
                 flags): NCCL on --device cuda, gloo on cpu; prints the
                 process summary unless -s.  Each process runs the same
                 solve, as the JAX CLI's do.

The file is read by the C++ g2o reader (io/native_parser.py), as the
reference's CLI reads it with its C++ parser; a line the Python parser
would read and the C++ reader cannot is an error.

The printed lines match the JAX CLI's: ``initial denormalized chi2 error``
(with -v, batch), ``done. it took``, ``solver took N iterations``,
``denormalized chi2 error``, the ``memory:`` line (-v), the ATE/RPE lines,
``marginals: mean pose sigma``, ``solution written to`` and ``plot written
to``;
a missing -i or a file with no edges prints the JAX CLI's error and
returns 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(
        prog="slam_plus_plus_tpu_torch",
        description="batch sparse nonlinear least squares (SLAM / BA) on PyTorch/CUDA")
    p.add_argument("-i", "--input", default=None)
    p.add_argument("-po", "--pose-only", action="store_true")
    p.add_argument("-nsp", "--nonlinear-solve-period", type=int, default=0)
    p.add_argument("-lsp", "--linear-solve-period", type=int, default=0)
    p.add_argument("-fL", "-L", dest="solver", action="store_const", const="fast_l")
    p.add_argument("-mnsi", type=int, default=10)
    p.add_argument("-nset", type=float, default=20.0)
    p.add_argument("-A", dest="solver", action="store_const", const="a")
    p.add_argument("-lm", "-,\\lm", dest="solver", action="store_const",
                   const="lambda_lm")
    p.add_argument("-dl", "-,\\dl", dest="solver", action="store_const",
                   const="lambda_dl")
    p.add_argument("-mfnsi", type=int, default=5)
    p.add_argument("-fnset", type=float, default=0.01)
    p.add_argument("-s", "--silent", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-us", "--use-schur", action="store_true")
    p.add_argument("-nb", "--no-bitmaps", action="store_true")
    p.add_argument("-dx", "--solution", default="solution.txt")
    p.add_argument("-gt", "--ground-truth", default=None)
    p.add_argument("--rpe-delta", type=int, default=1)
    p.add_argument("-dm", "--marginals", action="store_true")
    p.add_argument("-dsi", "--dump-each-step", default=None, metavar="DIR")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--native", action="store_true")
    p.add_argument("--dist-coord", default=None, metavar="HOST:PORT")
    p.add_argument("--dist-nprocs", type=int, default=None)
    p.add_argument("--dist-procid", type=int, default=None)
    p.add_argument("-rmut", "--run-matrix-unit-tests", action="store_true")
    p.add_argument("-rmb", "--run-matrix-benchmarks", nargs=2, metavar=("NAME", "TYPE"),
                   default=None)
    return p


class DatasetError(ValueError):
    """The input cannot be solved (the CLI prints it and returns 1)."""


def run(args):
    """Parse, solve (incremental: FastL or the incremental lambda solver;
    batch: GN, A, Lambda-LM or Lambda-DL), print the reference CLI's lines,
    evaluate against -gt, recover -dm's marginals, write -dx and, unless
    -nb, draw solution.png.  Returns
    (final chi2, iterations, the solver; with -dm the solver's
    ``marginals_report`` holds marginals_report's result); raises
    DatasetError on a file with no edges, UnsupportedReplay where --native
    asks the C++ engine for a replay it does not serve."""
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.io.parser import peek_dataset
    from slam_plus_plus_tpu_torch.solvers.a_solver import ASolver
    from slam_plus_plus_tpu_torch.solvers.dogleg import DoglegSolver
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
    from slam_plus_plus_tpu_torch.solvers.incremental import IncrementalSolver
    from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver
    from slam_plus_plus_tpu_torch.utils.memusage import format_report

    flags = peek_dataset(args.input)
    is_ba = flags["has_ba"] or flags["has_stereo"] or flags["has_spheron"]
    if not args.silent:
        fam = [k for k, v in flags.items() if v]
        print(f"dataset: {args.input} ({', '.join(fam) or 'unknown'})")
    t0 = time.perf_counter()
    system = parse_g2o_fast(args.input)
    t_parse = time.perf_counter() - t0
    if not args.silent:
        print(f"parsed {system.num_vertices} vertices, {system.num_edges} "
              f"edges in {t_parse:.3f}s")

    if not system.edge_stores:
        raise DatasetError("no edges in the dataset")

    dump_dir = args.dump_each_step
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
    n_dumped = [0]

    def dump_step(solver, _si, states):
        solver.asm.writeback_states(system, states)
        _dump_solution(system, os.path.join(dump_dir, f"solution_{n_dumped[0]:05d}.txt"))
        n_dumped[0] += 1

    t0 = time.perf_counter()
    kind = args.solver or ("lambda_lm" if is_ba else "lambda")
    if args.nonlinear_solve_period > 0 or args.linear_solve_period > 0:
        # incremental (JAX main.py:163-183): -lsp is one pushed iteration
        every_n = args.nonlinear_solve_period or args.linear_solve_period
        kw = dict(device=args.device, every_n=every_n,
                  max_iterations=args.mnsi if args.nonlinear_solve_period else 1,
                  dx_threshold=args.nset if args.nonlinear_solve_period else 0.0)
        if kind == "fast_l":
            solver = FastLSolver(system, native=args.native, **kw)
        else:
            solver = IncrementalSolver(system, on_step=dump_step if dump_dir else None,
                                       native=args.native, **kw)
        chi2, iters = solver.run(verbose=args.verbose)
    else:
        cls = {"lambda_lm": LevenbergMarquardtSolver, "lambda_dl": DoglegSolver,
               "a": ASolver}.get(kind, GaussNewtonSolver)
        solver = cls(system, device=args.device)
        if args.verbose:
            print(f"initial denormalized chi2 error: {solver.chi2():.2f}")
        chi2, iters = solver.optimize(args.mfnsi, args.fnset, verbose=args.verbose)
    solver.timing["parse"] = t_parse
    print(f"done. it took {time.perf_counter() - t0:.5f} sec")
    print(f"solver took {iters} iterations")
    print(f"denormalized chi2 error: {chi2:.2f}")
    if args.verbose:
        print(format_report(args.device))
    if args.ground_truth:
        _evaluate_vs_ground_truth(system, args.ground_truth, args.rpe_delta)
    if args.marginals:
        solver.marginals_report = marginals_report(system, args.device)
    if args.solution:
        _dump_solution(system, args.solution)
        if not args.silent:
            print(f"solution written to {args.solution}")
    if not args.no_bitmaps:
        from slam_plus_plus_tpu_torch.app.plot import plot_system
        try:
            out = plot_system(system, "solution.png")
            if out and not args.silent:
                print(f"plot written to {out}")
        except Exception as e:  # plotting is best-effort, like the reference
            print(f"warning: plot failed: {e}", file=sys.stderr)
    return chi2, iters, solver


def marginals_report(system, device):
    """-dm: a float64 assembly of the solved system on ``device``, its
    marginal covariances (the Marginals route for its size), and the JAX
    CLI's line ``marginals: mean pose sigma`` (the root of the mean |entry|
    of the pose blocks).  Returns (Marginals, the block system, the result,
    the line)."""
    import torch
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.marginals import Marginals

    asm = Assembler(system, device=device, dtype=torch.float64)
    bs = asm.assemble(asm.snapshot_states(system))
    marg = Marginals(asm)
    res = marg.compute(bs)
    line = f"marginals: mean pose sigma {float(torch.sqrt(res.p_diag.abs().mean())):.6f}"
    print(line)
    return marg, bs, res, line


def _evaluate_vs_ground_truth(system, gt_path, rpe_delta):
    """ATE/RPE of the solved trajectory against a ground-truth file (g2o
    vertex lines or a plain solution file), as the JAX CLI's
    _evaluate_vs_ground_truth (reference CErrorEvaluation,
    include/slam/ErrorEval.h:40,138,208-240, with Kabsch alignment)."""
    import numpy as np
    from slam_plus_plus_tpu_torch.evaluation.error_eval import evaluate_trajectory

    def load_states(path):
        rows = []
        with open(path) as f:
            for line in f:
                tok = line.split()
                if not tok:
                    continue
                if tok[0].upper().startswith("VERTEX"):
                    rows.append((int(tok[1]), np.array([float(x) for x in tok[2:]])))
                elif all(c in "0123456789.eE+- " for c in line.strip()):
                    rows.append((len(rows), np.array([float(x) for x in tok])))
        rows.sort(key=lambda r: r[0])
        return [r[1] for r in rows]

    gt = load_states(gt_path)
    est = [system.vertex_state(gid) for gid in sorted(system.vertex_directory)]
    n = min(len(gt), len(est))
    dim = min(min(len(g) for g in gt[:n]), min(len(e) for e in est[:n]))
    m = evaluate_trajectory(np.stack([e[:dim] for e in est[:n]]),
                            np.stack([g[:dim] for g in gt[:n]]), delta=rpe_delta)
    print(f"ATE RMSE: {m['ate_rmse']:.6f}")
    print(f"RPE trans RMSE: {m['rpe_trans_rmse']:.6f}  "
          f"rot RMSE: {m['rpe_rot_rmse']:.6f}  (delta={rpe_delta})")


def _dump_solution(system, path):
    """Vertex states in global-id order (reference CFlatSystem::Dump), in
    the JAX CLI's format."""
    with open(path, "w") as f:
        for gid in sorted(system.vertex_directory):
            f.write(" ".join(f"{v:.10f}" for v in system.vertex_state(gid)) + "\n")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.native and args.device != "cpu":
        print("error: --native runs the C++ replay engine on the host; pass --device cpu",
              file=sys.stderr)
        return 1
    if args.native and not (args.nonlinear_solve_period or args.linear_solve_period):
        print("error: --native serves the incremental solvers (-nsp / -lsp)", file=sys.stderr)
        return 1
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch sees no CUDA device; "
              "run on a GPU or pass --device cpu", file=sys.stderr)
        return 2
    from slam_plus_plus_tpu_torch.parallel import multihost
    # the multi-process runtime (parallel/multihost.py): every process then
    # runs the same solve, which is not routed through parallel/ (as in the
    # JAX CLI)
    if multihost.initialize(args.dist_coord, args.dist_nprocs, args.dist_procid,
                            device=args.device):
        if not args.silent:
            print(multihost.process_summary())
        try:
            return _main(args)
        finally:
            torch.distributed.destroy_process_group()
    return _main(args)


def _main(args) -> int:
    """main() past the checks and the process group."""
    # -rmut / -rmb return before any parse (reference src/slam_app/Main.cpp:91-104)
    if args.run_matrix_unit_tests:
        from slam_plus_plus_tpu_torch.app.block_unit import run_unit_tests
        return 0 if run_unit_tests(device=args.device, verbose=not args.silent) else 1
    if args.run_matrix_benchmarks is not None:
        from slam_plus_plus_tpu_torch.app.block_unit import run_benchmarks
        name, btype = args.run_matrix_benchmarks
        try:
            run_benchmarks(name, btype, device=args.device, verbose=not args.silent)
        except ValueError as e:     # the benchmark type
            print(f"error: -rmb: {e}", file=sys.stderr)
            return 1
        return 0
    if args.input is None:
        print("error: no input file (-i)", file=sys.stderr)
        return 1
    from slam_plus_plus_tpu_torch.solvers.native_engine import UnsupportedReplay
    try:
        run(args)
    except (DatasetError, UnsupportedReplay) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
