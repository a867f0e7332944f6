"""The acceptance suite in the port: scripts/acceptance.py's rows on the card.

    python -m slam_plus_plus_tpu_torch.app.acceptance [--quick] [--rows SUBSTR]
        [--out FILE] [--device cuda|cpu]

The analogue of the reference's unit_tests.sh, as scripts/acceptance.py
(which imports JAX and stays the JAX package's): every row of that script,
each on the file the port's generators write for it (io/acceptance.py,
cached beside the built kernels), run through the CLI's code path
(``app.main.run``): the batch pose-graph rows by GN or LM, the two BA rows
(venice-class, the bench scene, and venice-real) by LM, the incremental
rows by ``-nsp 1`` with and without ``-fL``.  There is no reference binary
here: each row is gated at 1.05 x the golden io/acceptance.py stores (the
JAX script's ``--no-ref`` replay against recorded goldens, the only mode).

Per row a detail line, then one JSON line: name, chi2, golden, ratio,
iterations, wall seconds, ms per iteration (batch rows: the steady
iterations after the CLI's run, timed on a host clock that ends in a
synchronize) or per solve point (incremental rows), dtype, device, the
launches of kernels K1 and K2 during the row, passed.
Last, ``{"passed": n, "total": m}``; the exit code is 1 when a row misses
its gate.  ``--out`` writes the rows as a JSON list (never the JAX side's
docs/ACCEPTANCE*.md).  ``--quick`` keeps the JAX script's quick rows.

``pose_row`` and ``incremental_row`` are also chip_smoke.py's row runners.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from slam_plus_plus_tpu_torch.io import acceptance as goldens

#: timed iterations of a batch row, after one warm-up
POSE_STEPS = 3

#: (row name, dataset, kind, quick): scripts/acceptance.py:145-182 in its
#: order; the batch rows take io/acceptance.py ROWS[dataset]'s flags and
#: golden, the incremental rows are INCREMENTAL_ROWS's labels
ROWS = [
    ("manhattan3500 batch -po", "manhattan3500", "batch", True),
    ("intel-scale batch -po", "intel-scale", "batch", True),
    ("city10k batch -po", "city10k", "batch", True),
    ("sphere2500 batch (LM)", "sphere2500", "batch", True),
    ("garage3d batch (LM)", "garage3d", "batch", True),
    ("trees10k batch (landmarks)", "trees10k", "batch", True),
    ("w100k batch -po", "w100k", "batch", False),
    ("venice-class batch (LM)", "venice-class", "batch", False),
    ("venice-real batch (LM)", "venice-real", "batch", False),
    ("manhattan3500 -nsp 1", "manhattan3500 -nsp 1", "incremental", False),
    ("city10k -nsp 1", "city10k -nsp 1", "incremental", False),
    ("manhattan3500 -nsp 1 -fL", "manhattan3500 -nsp 1 -fL", "incremental", False),
    ("intel-scale -nsp 1 -fL", "intel-scale -nsp 1 -fL", "incremental", True),
    ("vp-scale -nsp 1 -fL", "vp-scale -nsp 1 -fL", "incremental", False),
    ("trees10k-incr -nsp 1 -fL", "trees10k-incr -nsp 1 -fL", "incremental", False),
]


def dataset(name: str) -> str:
    """The row's file, written beside the built kernels on first use."""
    from slam_plus_plus_tpu_torch.ops import _build

    return goldens.dataset(name, _build.BUILD_DIR)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(dev) -> str:
    if dev.type != "cuda":
        return "not measured (host)"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"


def gate(label, chi2, golden, start):
    """(passed, verdict): chi2 <= GATE x golden, or, for a row of
    FLOAT32_MISSES, finite and below start() (its starting chi2) and, where
    the row has one, under its recorded bound x golden."""
    if not math.isfinite(chi2):
        return False, "NOT FINITE against"
    bound = goldens.GATE * golden
    if label not in goldens.FLOAT32_MISSES:
        return chi2 <= bound, "<=" if chi2 <= bound else "MISSES"
    recorded, miss_bound = goldens.FLOAT32_MISSES[label]
    ok = chi2 < start() and (miss_bound is None or chi2 <= miss_bound * golden)
    if miss_bound is not None:
        recorded += f"; held at {miss_bound} x golden"
    return ok, ("<=" if chi2 <= bound else
                f"MISSES, as float32 with the JAX package's settings does ({recorded}):")


def symmetry_residual(asm, bs):
    """Largest |H - H^T| over lambda's diagonal blocks (pp and ll)."""
    d = bs.pp_blocks.index_select(0, asm.pp_diag_ids_dev)
    worst = float((d - d[:, asm._p_tperm]).abs().max())
    if asm.Nl:
        worst = max(worst, float((bs.ll_blocks - bs.ll_blocks[:, asm._l_tperm]).abs().max()))
    return worst


def pose_row(dev, card, name, flags, golden, float32_control=False):
    """One batch row through the CLI's code path (pose graphs float64 on
    the card, the pose-graph route's dtype; BA float32, the Schur route's),
    then its timed steady iterations.  float32_control: the same GN solve
    (the CLI's settings) with dtype=torch.float32 instead, held only finite
    and below its start (float32 missed the gates: ROADMAP.md Queue 3, F1).
    Returns (the row's dict, the solver, its final states, the step
    function)."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.a_solver import ASolver
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver, PCG_REL_TOL
    from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

    dev = torch.device(dev)
    path = dataset(name)
    label = f"{name} -A" if "-A" in flags else name
    args = cli.build_argparser().parse_args(
        ["-i", path, "--device", dev.type, "-s", "-dx", ""] + flags)
    _reset_peak(dev)
    t0 = time.perf_counter()
    if float32_control:
        if flags != ["-po"]:
            raise ValueError(f"{label}: the float32 control runs GN rows only")
        label += ", float32 control"
        t1 = time.perf_counter()
        system = parse_g2o_fast(path)
        t_parse = time.perf_counter() - t1
        solver = GaussNewtonSolver(system, device=dev, dtype=torch.float32)
        solver.timing["parse"] = t_parse
        chi2, iters = solver.optimize(args.mfnsi, args.fnset)
    else:
        chi2, iters, solver = cli.run(args)
    wall = time.perf_counter() - t0
    asm = solver.asm
    a_solver = isinstance(solver, ASolver)
    lm = isinstance(solver, LevenbergMarquardtSolver)

    def start():
        if a_solver:
            return float(asm.chi2(asm.snapshot_states(parse_g2o(path))))
        return solver.initial_chi2 if lm else solver.iteration_log[0][0]

    if float32_control:
        passed = math.isfinite(chi2) and chi2 < start()
        verdict = "(not gated: finite and below its start) against"
    else:
        passed, verdict = gate(label, chi2, golden, start)
    # pose graphs run float64 on the card (gauss_newton.route_dtype), BA
    # float32; float64 everywhere on the CPU
    want = (torch.float32 if float32_control or (name in goldens.BA_ROWS and
                                                 dev.type == "cuda") else torch.float64)
    if asm.dtype != want:
        raise RuntimeError(f"{label}: {asm.dtype} on {dev}, not {want}")
    pcg = [int(t) for t in solver.pcg_taken]
    states = asm.snapshot_states(solver.system)
    base = asm.assemble(states)
    sym = symmetry_residual(asm, base)
    alpha = float(base.max_hdiag) * 1e-3

    def step(st):
        """One GN iteration (assemble, solve, the host read of chi2 and |dx|,
        update), one A-solver iteration (A on the host, LSQR, update), or
        one LM trial (damp, solve, update, re-assemble, its host read) from
        the fixed base."""
        if a_solver:
            dx_p, dx_l, _norm = solver._solve_via_A(st)
            return asm.update(st, dx_p, dx_l), None
        if lm:
            new, _sys, n, e, den = solver._trial(st, base, alpha)
            torch.stack([n, e, den]).tolist()
            return new, e
        bs = asm.assemble(st)
        dx_p, dx_l = solver._solve(bs)
        torch.stack([bs.chi2, torch.sum(dx_p * dx_p) + torch.sum(dx_l * dx_l)]).tolist()
        return asm.update(st, dx_p, dx_l), bs.chi2

    step(states)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(POSE_STEPS):
        step(states)
    _sync(dev)
    ms_iter = (time.perf_counter() - t0) / POSE_STEPS * 1e3
    chol = solver._sparse_chol
    sch = solver._schur
    branch = ("A solver: A built on the host, LSQR" if a_solver else
              (f"sparse-reduced Schur, {sch.reduced_chol.n_levels} MIS levels"
               if sch.sparse_reduced else "dense Schur") if sch is not None else
              "dense" if solver._dense is not None else
              f"block Cholesky, {chol.n_levels} MIS levels, bottom {chol.plan.n_bottom} "
              f"blocks, " + (f"PCG stop {PCG_REL_TOL:g}, iterations per solve {pcg}"
                             if solver.pcg_iterations else "no PCG"))
    kind = "A" if a_solver else "LM" if lm else "GN"
    print(f"pose row {label} ({kind}, {str(asm.dtype)[6:]}; {solver.system.num_vertices} "
          f"vertices, {solver.system.num_edges} edges; {asm.Np} x {asm.Bp} + {asm.Nl} x "
          f"{asm.Bl} dims; {branch}): chi2 {chi2:.2f} in {iters} iterations {verdict} "
          f"{goldens.GATE} x {golden} (ratio {chi2 / golden:.4f}); {ms_iter:.2f} ms/iteration "
          f"steady ({POSE_STEPS} after a warm-up; the CLI's optimize "
          f"{solver.timing['optimize'] / iters * 1e3:.2f} ms/iteration with its first); CLI "
          f"path {wall:.1f} s (parse {solver.timing['parse']:.1f} s, construct "
          f"{solver.timing['construct']:.1f} s); max |H - H^T| over diagonal blocks {sym:g}; "
          f"peak device memory {_peak(dev)}; on {card}", flush=True)
    row = dict(row=label, chi2=chi2, golden=golden, ratio=chi2 / golden, iterations=iters,
               wall_s=wall, ms_per_iteration=ms_iter, dtype=str(asm.dtype)[6:],
               device=str(dev), passed=bool(passed))
    return row, solver, states, step


def incremental_row(dev, card, label):
    """One incremental row (io/acceptance.py INCREMENTAL_ROWS) through the
    CLI's code path, float64.  Returns (the row's dict, the FastL engine)."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

    dev = torch.device(dev)
    name, flags, golden, golden_iters = goldens.INCREMENTAL_ROWS[label]
    path = dataset(name)
    args = cli.build_argparser().parse_args(
        ["-i", path, "--device", dev.type, "-s", "-dx", ""] + flags)
    _reset_peak(dev)
    t0 = time.perf_counter()
    chi2, iters, solver = cli.run(args)
    wall = time.perf_counter() - t0
    fl = getattr(solver, "_delegate", None) or solver
    if not isinstance(fl, FastLSolver) or fl.asm.dtype != torch.float64:
        raise RuntimeError(f"{label}: not the float64 maintained-factor engine")
    passed, verdict = gate(label, chi2, golden, lambda: float(
        fl.asm.chi2(fl.asm.snapshot_states(parse_g2o(path)))))
    st, inc = fl.stats, fl.inc
    ms_point = st["elapsed"] / max(st["solve_points"], 1) * 1e3
    print(f"incremental row {label} ({fl.system.num_vertices} vertices, "
          f"{fl.system.num_edges} edges; {fl.asm.Np} x {fl.asm.Bp} dims, one mixed class): chi2 "
          f"{chi2!r} in {iters} iterations, {st['pushes']} pushes {verdict} {goldens.GATE} x "
          f"{golden} (ratio {chi2 / golden:.4f}; the reference {golden} in {golden_iters} "
          f"iterations); {st['solve_points']} solve points, {ms_point:.2f} ms per solve point "
          f"(replay {st['elapsed']:.1f} s / solve points); {st['full_refactors']} full "
          f"refactors, {st['dirty_overflows']} dirty overflows (caps d/e/w/p {inc.cap_d}/"
          f"{inc.cap_e}/{inc.cap_w}/{inc.cap_p}); {len(fl.chol.plan.levels)} MIS levels, bottom "
          f"{fl.chol.plan.n_bottom} blocks; wall {wall:.1f} s (parse {fl.timing['parse']:.1f} s, "
          f"construct {fl.timing['construct']:.1f} s); peak device memory {_peak(dev)}; on "
          f"{card}", flush=True)
    row = dict(row=label, chi2=chi2, golden=golden, ratio=chi2 / golden, iterations=iters,
               pushes=st["pushes"], wall_s=wall, ms_per_solve_point=ms_point,
               solve_points=st["solve_points"], dtype="float64", device=str(dev),
               passed=bool(passed))
    return row, fl


def run_row(dev, card, name, ds, kind):
    """One row of ROWS: its dict, with the kernels' launches during it."""
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    before = (p2c_edge_terms.launches, build_panels.launches)
    if kind == "incremental":
        row = incremental_row(dev, card, ds)[0]
    else:
        flags, golden = goldens.ROWS[ds]
        row = pose_row(dev, card, ds, flags, golden)[0]
    row["row"] = name
    row["launches"] = {"p2c_edge_terms": p2c_edge_terms.launches - before[0],
                       "build_panels": build_panels.launches - before[1]}
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slam_plus_plus_tpu_torch.app.acceptance")
    p.add_argument("--quick", action="store_true", help="only the quick rows")
    p.add_argument("--rows", default=None, help="only the rows whose name holds this")
    p.add_argument("--out", default=None, help="write the rows as a JSON list here")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("error: --device cuda, but torch sees no CUDA device; run on a GPU or "
                  "pass --device cpu", file=sys.stderr)
            return 2
        from slam_plus_plus_tpu_torch.bench import card_line

        card = card_line()
        print(f"card: {card}", flush=True)
    else:
        card = "the host CPU"
    results = []
    for name, ds, kind, quick in ROWS:
        if (args.quick and not quick) or (args.rows and args.rows not in name):
            continue
        row = run_row(dev, card, name, ds, kind)
        results.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print(json.dumps({"passed": sum(r["passed"] for r in results), "total": len(results)}))
    return 0 if all(r["passed"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
