#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (slam_plus_plus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and nothing but this repository;
it never falls back to the CPU.  Phases, each of which must pass:

  1. build the hand-written kernels (csrc/*.cu) with nvcc for sm_90a;
  2. K1 (p2c_edge_terms) and K2 (build_panels) against their plain torch
     versions on the card at the bench shapes, float32 and float64 (K1 also
     at venice-real's 800,000 slots, reported under its "venice_real" key), with
     CUDA-event times of both beside each kernel's bound; K2 on the solver's
     strided view of its blocks, bitwise, at the bench shape and at a second
     one whose panel rows need several column windows and whose ranges start
     off 16-byte lines (1000 points, 75 slots, 871 cameras);
  3. a small scene assembled on the card (float32) against the CPU float64
     path, which the tests hold against the JAX package;
  4. the main path at full size: the bench scene (100 cameras, 8000 points,
     seed 77, as bench.py), 1 warm-up + 4 timed damped Schur steps exactly as
     bench.py times them, gated at chi2 <= 1.05 x the reference's 222855.82,
     a per-stage split, then Lambda-LM optimize(5, 0.01) through the CLI's
     code path;
  5. both kernels' launch counters grew during phase 4;
  6. a torch.profiler trace of the timed step: device time per kernel, the
     sum and the union of kernel intervals, and the device's idle share of
     the same run's wall time; and a trace of one panels stage, which must
     hold K2 and no fill kernel;
  7. pose-graph SLAM (no Pallas kernel lies on this path): a small SE(2) and
     a small SE(3) graph assembled on the card (float32) against the CPU
     float64 path; a small landmark graph solved by GN through the flat
     Schur branch on the card (float32, the Schur route's dtype) against
     the CPU float64 run; the manhattan3500 lambda solved on the card in
     float32 (dtype=torch.float32) with the block Cholesky and its PCG,
     gated on the true relative residual; then the acceptance rows
     manhattan3500, city10k, sphere2500 and trees10k, built with the port's
     generators at the settings of scripts/acceptance.py, each solved
     through the CLI's code path in float64 (the pose-graph route's dtype,
     solvers/gauss_newton.py::route_dtype) and gated at chi2 <= 1.05 x the
     reference binary's golden (docs/ACCEPTANCE_TPU.md); per row the
     iterations, ms per iteration, MIS levels, bottom blocks, the largest
     |H - H^T| over lambda's diagonal blocks and the peak device memory;
     manhattan3500 once more by GN in float32 as the control (printed
     against the gate, held finite and below its start: float32 missed it,
     ROADMAP.md Queue 3 F1); and a torch.profiler trace of two city10k GN
     iterations;
  8. the rest of batch BA: (a) a small scene forced through the
     sparse-reduced Schur (sparse_reduced_limit=1), its clique and gathered
     paths on the card (float32) against the CPU's solve of the same float32
     lambda (1e-4 x scale) and the CPU float64 solve (2e-3 x scale: the JAX
     package's float32 bottom ridge); (b) small intrinsics, stereo and
     spheron files through LM (float32) and a stereo (-mfnsi 30) and a mono
     BA file through -dl (float64, config.float64_dtype), by the CLI's code
     path, final chi2 within 1e-4 of the CPU float64 run; (c) the
     venice-real row (871 cameras, 100,000 points, 800,000 observations,
     io/acceptance.py) through the CLI's code path: the sparse-reduced Schur
     with its clique path, LM's 5 iterations gated at chi2 <= 1.05 x the
     reference binary's 323432.49, the trajectory against the reference's,
     ms per LM iteration over 3 more iterations, a stage split of one
     solve, peak device memory and a profile of one LM iteration; (d) K1
     launched during that row and K2 not;
  9. the rest of batch solving (no Pallas kernel lies on this path): small
     Sim(3) chain, inverse-distance Sim(3) BA and ROCV scenes solved on the
     card (in their route's dtype: float64 for the chain, float32 for the
     BA and the small ROCV scene, whose landmark class is split off) and on
     the CPU (float64), final chi2 within 1e-3 relative; sim3.exp's float32
     error across its small-angle threshold; the acceptance rows w100k
     (100,000 poses: GN, block Cholesky), intel-scale (GN and -A) and
     garage3d (LM) through the CLI's code path in float64 and city10k
     through the SPCG solver (float32) with its spanning-tree
     preconditioner, each gated at chi2 <= 1.05 x the reference binary's
     golden as in phase 7, with iterations, ms per iteration, parse and
     construct seconds and peak device memory, the tree solve's and the CG
     solve's times; w100k once more by GN in float32 as the control (block
     Cholesky capped at 8 levels, PCG; held as phase 7's control); full-size runs of a Sim(3)
     inverse-distance BA (100 cameras, 10,000 points, LS and LO edges, LM;
     the median of 5 timed LM trials and a profile of one) and of the
     ROCV scene at 10,000 steps (GN through the CLI's code path), chi2 per
     iteration finite and not rising (beyond float32's
     1e-3 wander at the optimum); K1 and K2 launched 0 times;
 10. incremental solving (no Pallas kernel lies on this path either), in
     float64, the incremental engine's dtype on the card
     (config.float64_dtype): (a) a small manhattan -nsp 1 -fL replay by
     the float32 engine (dtype=torch.float32) on the card: the maintained
     factor's flat stores after the first dirty step within 1e-4 x scale of
     the same step on the CPU from the same float32 inputs, their DUMMY rows
     zero, their largest error against the CPU float64 replay's printed
     (not gated: the float32 pivot ridge), the final chi2 within 1e-3
     relative of the JAX package's float32 replay (float32 ends 10.3% above
     float64 on this file, in both packages); (b) the six incremental
     acceptance rows (io/acceptance.py INCREMENTAL_ROWS: manhattan3500 and
     city10k -nsp 1, manhattan3500, intel-scale, vp-scale and trees10k-incr
     -nsp 1 -fL) through the CLI's code path in float64, each gated at chi2
     <= 1.05 x the reference binary's golden as in phase 7, with
     iterations and pushes beside the golden's, wall seconds, ms per solve
     point, solve points, full refactors, dirty overflows, MIS levels, the
     bottom size and peak device memory; (c) a torch.profiler trace of 20
     solve points of manhattan3500 -fL: device activities per solve point
     and the idle share; (d) K1 and K2 launched 0 times;
 11. marginal covariances (marginals/covariance.py), all float64 on the
     card: (a) each route of Marginals on small scenes (dense and sparse
     pose-only, the flat Schur route whole and, on a second file, in
     chunks of 8 landmarks,
     the sparse-reduced Schur, and the uniform BA route through K1 and K2)
     against the CPU port on the same lambda at max(1e-10, kappa x eps) x
     scale (kappa: the condition number of the diagonally equilibrated
     lambda), the card's float64 assembly at 1e-10 x scale, and one
     IncrementalMarginals Woodbury update against a recompute; (b) the pose
     rows manhattan3500, city10k and sphere2500 through the CLI's code path
     with -dm (the recurrent recovery): 12 sampled vertices' Sigma blocks
     against host splu columns of the same lambda at max(1e-7, kappa x
     eps) x scale, the route, MIS levels, bottom blocks, ms per recovery,
     the printed line and peak memory; (c) the bench scene (the uniform route, K1 and K2, whose
     launch counters must grow) and venice-real from phase 8 (the chunked
     flat route), each against mode="sparse_schur" at MARG_BA_TOL x scale
     on p_diag and l_diag's real dims, with ms per recovery and peak
     memory; (d) FastL with marginals=True on manhattan3500
     and intel-scale -nsp 1 -fL: the final chi2 equal to phase 10's to 1e-9
     relative, the last maintained Sigma diagonal against a recompute from
     its stores at 1e-8 x scale and every Woodbury update against one at
     1e-6 (the JAX package's bound), the counts of update and recalculate and
     the ms per solve point with and without marginals; (e) the
     data-association app on its 120-pose sphere: the same decisions on the
     card as on the CPU; the kernels' launches during the phase join their
     JSON entries;
 12. incremental BA, the online FastL and -dsi (no Pallas kernel lies on
     this path), float64: (a) the JAX test's 12-camera / 300-point marker
     file replayed by the incremental dogleg (solvers/dogleg_incremental.py)
     on the card and on the CPU port, per-marker chi2 within 1e-9 relative,
     the card's maintained lambda pieces and SC within 1e-7 x scale of a
     fresh assembly; (b) the bench scene written as 50 markers of 2
     cameras (app/incremental_ba.py) and replayed on the card: the final
     chi2 <= 1.05 x the batch dogleg's (optimize(20, 1e-3), float64, flat
     layout), the maintained state against a fresh assembly, fewer
     refreshed edges than a full relinearization every iteration, ms per
     marker and per DL iteration, a profile of the last 3 markers (idle
     share), peak memory, and the maintained-state marginals against
     Marginals on the fresh assembly at MARG_BA_TOL x scale (gauge damping
     1e-6); (c) the online FastL (solvers/fastl_online.py): a 200-pose
     manhattan with no growth against the card's replay FastL (1e-6) and
     the CPU port's stream (1e-8 relative), and the intel-scale file
     streamed edge by edge from a capacity of 128 with a fringe of 64,
     within the JAX test's rebuild bound and chi2 <= 1.3 x phase 10's
     replay + 10, with rebuilds, closures, solve points, pushes, rebuild
     seconds, ms per edge and per solve point; (d) -dsi on a small
     manhattan with -nsp 1 through the CLI's code path: as many dumps on
     the card as on the CPU, the card's last equal to its -dx file and
     within 1e-8 x scale of the CPU's; K1 and K2 launched 0 times;
 13. the native host code, the facade and the rest of the CLI: (a) the
     C++ g2o reader (io/native_parser.py, built with g++) against the
     Python parser on venice-real and the bench scene, equal systems, with
     each reader's seconds (phase 8's venice row already parsed through the
     C++ reader, its seconds printed there); (b) the C++ replay engine
     (solvers/native_engine.py) on the host's CPU through the CLI's code
     path with --device cpu --native on the incremental rows of NATIVE_ROWS,
     each gated as in phase 10, with wall, parse, construct and replay
     seconds, ms per solve point and phase 10's card reading of the same
     row beside it (the crossover), the host's CPU model beside the card's
     name; and a small replay, C++ engine against the torch engine on the
     CPU; (c) BAOptimizer(device="cuda") fed the bench scene one call at a
     time (equal to the parsed file), LM optimize(5) gated at 1.05 x
     222855.82 with K1 and K2 launched, and covariances() against the
     sparse-reduced Schur route at phase 11's tolerance; (d) the port's C
     API built, native/ba_c_test.c linked against it with gcc and run with
     SLAMPP_DEVICE unset: exit 0 and "C API OK"; (e) -rmut returns 0 and
     -rmb synthetic factor prints its sheet, on the card; (f) one CLI run's
     -v memory line with the card's peak;
 14. the host tools and the two example apps, on the card: (a)
     linalg/eigen.py's sym_eigs(k=6, "LM") on the bench scene's lambda,
     assembled in float64 through K1 (24,600 dims, the port's own LOBPCG
     over LambdaSpmv): every Ritz pair's residual |lambda v - w v| / |w|
     <= 1e-4 and the top eigenvalue within 1e-4 of a float64 power
     iteration over the same operator, ms per LOBPCG iteration,
     torch_cost of one operator call; (b) condition_estimate on manhattan
     300 (seed 3, loop 0.3), float64: the dense route and the block
     Cholesky route (_DENSE_LIMIT lowered) within 5%, then the block
     Cholesky route on city10k (30,000 dims): finite and > 10, with its
     seconds; (c) nested_schur_analysis of venice-real's structure: level
     0 eliminates its 100,000 points, the levels printed; (d)
     save_matrix_market of city10k's float64 lambda from the card: the
     file read back by scipy equals the card's blocks exactly; (e)
     geometry/polynomial.py on 2^20 random quadratics, cubics and quartics
     on the card against the CPU in float64 (polished roots within 1e-9
     x scale x kappa, raw roots past that bound in no more than 2 x the
     CPU's lanes + 16, equal root counts, ms per batch) and average_structure of 10,000
     noisy observations of a 100-point structure against the CPU (1e-10);
     (f) app/ba_parameter_acra.py's run_comparison() at its defaults and
     app/poly_fitting.py's fit on the example's data, on the card against
     the CPU (float64 both: rows within 1e-6 relative, coefficients within
     1e-8), gated as the JAX tests gate them; (g) utils/flops.py's
     assembly and Schur FLOP counts at the bench scene beside phase 4's
     stage times (GFLOP/s per stage), and a StageTimer(device=cuda) dump of
     the phase's parts; K1 launched during the phase (its count joins K1's
     JSON entry), K2 not.
     Phase 10's to phase 14's and the whole smoke's wall times are
     printed;
 15. parallel/ over torch.distributed, each rank a spawned process on the
     one card: (a) ShardedBAOptimizer on the bench scene over 2 gloo ranks
     (float32), 3 damped steps against phase 4's single-process card step
     (chi2 per step within 1e-5 relative, states within 1e-4 x scale),
     each rank holding G = 4,000 landmark rows and launching K1 and K2
     (counters zeroed just before the steps, read just after), with ms per
     step, each collective's ms and share of the step (CUDA events around
     it), peak device memory and per_device_bytes(); (b) the same at world
     size 1 over NCCL; (c) DistributedAssembler + DistributedSchurSolver on
     the bench scene over the 2 gloo ranks against the single-process card
     assembly of the same (flat) layout and its step at phase 3's float32
     tolerances (the uniform K1 assembly's distance printed beside), with
     ms and collective shares; (d) DistributedBlockCholeskySolver on
     city10k's and w100k's float64 lambda over the 2 gloo ranks: the
     relative residual of its solve and of solve_with_factor on its
     replicated factor (which must repeat the solve bit for bit under
     deterministic algorithms) <= 1e-10,
     under torch.use_deterministic_algorithms and with the default
     algorithms, beside the same rank's single-process factor's residual,
     two single-process solves that must be equal bit for bit under both
     (the factor's segmented sums, ops/segsum.py) and the forward distance
     between the single-process and the distributed solve (printed, not
     gated: 1-ulp differences in the ranks' batched products reach 1e-7
     through these lambdas), ms per factor of both and the collective
     shares; (e) two CLI processes joined by --dist-* on the card (NCCL,
     no collective): each prints its process summary and exits 0;
 16. the port's entry points, each in its own process: (a) python -m
     slam_plus_plus_tpu_torch.bench exits 0 and its last line holds
     metric "ba_solve_iter", value, unit, vs_baseline, the fastl_m3500_*
     keys of its C++-engine extra, both kernels' launches in its run and
     chi2 <= 1.05 x 222855.82; (b) python -m
     slam_plus_plus_tpu_torch.app.acceptance --rows intel-scale exits 0
     with passed == total over its two rows; (c) the repeat check of the
     deterministic sums: intel-scale and manhattan3500 -nsp 1 -fL replayed
     once more through the acceptance runner's row code must read phase
     10's chi2 to the bit.

The last two lines are a JSON object describing each kernel and the result
line {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 2024
N_CAMS, N_POINTS, SCENE_SEED = 100, 8000, 77      # bench.py's scene
TIMED_STEPS = 4
REF_FINAL_CHI2 = 222855.82                        # bench.py's gate
BENCH_E, BENCH_NL, BENCH_M = 608000, 8000, 76     # uniform layout of that scene
BENCH_MIN_OBS = 32                                # its least-observed landmark
VENICE_E = 800000                                 # venice-real's slots: M = 8, no dummies
K2_WIDE = (1000, 75, 871)     # Nl, M, cameras: several windows, odd M and cameras
HBM_BYTES_PER_S = 3.35e12                         # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {4: 67e12, 8: 34e12}                 # float32 / float64 outside tensor cores
P2C_FLOPS_PER_SLOT = 420   # counted in csrc/p2c.cu; sin, cos, sqrt, division one each


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


T_START = time.perf_counter()


def main() -> int:
    import torch

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        print("error: torch sees no CUDA device; chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    sys.path.insert(0, REPO)
    from slam_plus_plus_tpu_torch.config import pin_precision
    from slam_plus_plus_tpu_torch.ops import _build

    pin_precision()
    dev = torch.device("cuda", 0)

    # ---- 1. build ---------------------------------------------------------
    _, secs, per_source, log = _build.build(force=True)
    print(f"build: {secs:.1f} s -> {os.path.relpath(_build.LIB_PATH, REPO)}; one nvcc per "
          f"source, in parallel: " + ", ".join(f"{s} {t:.1f} s" for s, t in per_source.items())
          + f" (one after another: {sum(per_source.values()):.1f} s)")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")

    # ---- 2. kernels against their plain versions ---------------------------
    k1 = kernel_phase_p2c(torch, dev)
    k2 = kernel_phase_panels(torch, dev)

    # ---- 3. small scene, card float32 against CPU float64 -------------------
    small_scene_check(torch, dev)

    # ---- 4. main path at full size -----------------------------------------
    step, states0, panels_stage, stage_split = main_path(torch, dev, card, (k1, k2))

    # ---- 6. where the device time of a step goes ----------------------------
    profile_steps(torch, step, states0)
    profile_panels_stage(torch, panels_stage)

    # ---- 7. pose-graph SLAM -------------------------------------------------
    pose_graph_phase(torch, dev, card)

    # ---- 8. the rest of batch BA ------------------------------------------
    t0 = time.perf_counter()
    sparse_schur_check(torch, dev)
    ba_family_rows(torch, dev)
    venice_system = venice_row(torch, dev, card, k1)
    print(f"phase 8 (the rest of batch BA): {time.perf_counter() - t0:.1f} s wall")

    # ---- 9. the rest of batch solving ------------------------------------
    t0 = time.perf_counter()
    rest_of_batch_phase(torch, dev, card)
    print(f"phase 9 (the rest of batch solving): {time.perf_counter() - t0:.1f} s wall")

    # ---- 10. incremental solving ------------------------------------------
    t0 = time.perf_counter()
    phase10 = incremental_phase(torch, dev, card)
    print(f"phase 10 (incremental solving, float64): {time.perf_counter() - t0:.1f} s wall")

    # ---- 11. marginal covariances -------------------------------------------
    t0 = time.perf_counter()
    marginals_phase(torch, dev, card, (k1, k2), venice_system, phase10)
    del venice_system
    print(f"phase 11 (marginal covariances, float64): {time.perf_counter() - t0:.1f} s wall")

    # ---- 12. incremental BA and online FastL ---------------------------------
    t0 = time.perf_counter()
    incremental_ba_phase(torch, dev, card, phase10["intel-scale -nsp 1 -fL"][0])
    print(f"phase 12 (incremental BA, online FastL, -dsi; float64): "
          f"{time.perf_counter() - t0:.1f} s wall")

    # ---- 13. the native host code, the facade, the C API, -rmut / -rmb / -v ----
    t0 = time.perf_counter()
    native_phase(torch, dev, card, (k1, k2), phase10)
    print(f"phase 13 (the C++ reader and engine, the BA facade and its C API, -rmut / -rmb "
          f"/ -v): {time.perf_counter() - t0:.1f} s wall")

    # ---- 14. the host tools and the two example apps ------------------------
    t0 = time.perf_counter()
    tools_phase(torch, dev, card, (k1, k2), stage_split)
    print(f"phase 14 (eigensolver, condition estimate, nested Schur, MatrixMarket, "
          f"polynomials, structure average, the apps, FLOP counts): "
          f"{time.perf_counter() - t0:.1f} s wall")

    # ---- 15. parallel/ over torch.distributed -------------------------------
    t0 = time.perf_counter()
    parallel_phase(torch, dev, card, (k1, k2), step, states0)
    print(f"phase 15 (parallel/: sharded BA, distributed assembly, Schur and block "
          f"Cholesky, the CLI's --dist-*): {time.perf_counter() - t0:.1f} s wall")
    # ---- 16. the entry points; the deterministic sums repeat ----------------
    t0 = time.perf_counter()
    entry_points_phase(torch, dev, card, phase10)
    print(f"phase 16 (the bench and acceptance entry points, the repeat of the "
          f"incremental rows): {time.perf_counter() - t0:.1f} s wall")
    print(f"the whole smoke: {time.perf_counter() - T_START:.1f} s wall")

    print(f"card: {card}")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cuda_ms(torch, fn, reps=10, rounds=5):
    """Device time of fn() in ms: CUDA events around `reps` back-to-back
    calls, over reps, the median of `rounds` such runs, after a warm-up.
    The host enqueues ahead of the device unless a call's host work is the
    longer of the two."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def call_ms(torch, fn, reps=11):
    """Median CUDA-event time of one call of fn() in ms, from an idle device,
    so the call's host work counts."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops, itemsize):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, name, got, want, tol, names):
    """Max |got - want| over outputs, and max of it over each output's scale
    (printed per output); fails above tol * scale."""
    abs_err, rel_err, per = 0.0, 0.0, []
    for n, g, w in zip(names, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{name} {n} shape")
        check(bool(torch.isfinite(g).all()), f"{name} {n} not finite")
        err = float((g - w).abs().max())
        scale = max(float(w.abs().max()), 1.0)
        check(err <= tol * scale, f"{name} {n}: {err:.3e} > {tol:g} x {scale:.3e}")
        abs_err, rel_err = max(abs_err, err), max(rel_err, err / scale)
        per.append(f"{n} {err / scale:.1e}")
    print(f"  {name} err/scale: " + ", ".join(per))
    return abs_err, rel_err


def p2c_inputs(E, dummy_share, seed=SEED):
    """Random K1 inputs [11, E] [3, E] [2, E] [4, E] (float64 numpy):
    cameras near the origin looking down +z at a cloud 4..8 deep, as in the
    bench scene (every point well in front of its camera), a dummy_share
    of zero-information slots."""
    rng = np.random.default_rng(seed)
    cam = np.zeros((11, E))
    cam[0:3] = rng.normal(0, 0.3, (3, E))
    cam[3:6] = rng.normal(0, 0.1, (3, E))
    cam[3:6, :1000] = 0.0                                  # theta = 0
    cam[6:8] = rng.uniform(450, 550, (2, E))
    cam[8:10] = rng.uniform(300, 340, (2, E))
    cam[10] = rng.normal(0, 1e-7, E) * cam[6:8].mean(0)    # k r^2 ~ 1e-2
    pt = rng.uniform(-2, 2, (3, E))
    pt[2] += 6.0
    z = np.stack([rng.uniform(0, 640, E), rng.uniform(0, 480, E)])
    info = np.tile(np.array([[1.0], [0.0], [0.0], [1.0]]), (1, E))
    dummy = rng.random(E) < dummy_share
    info[:, dummy] = 0.0
    z[:, dummy] = 0.0
    return cam, pt, z, info


def kernel_phase_p2c(torch, dev):
    """K1 against its plain version at the bench scene's E (with its dummy
    share) and at venice-real's (800,000 slots, none of them dummies)."""
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms, p2c_edge_terms_plain

    result = None
    for E, share in ((BENCH_E, (BENCH_E - 457543) / BENCH_E), (VENICE_E, 0.0)):
        inputs = p2c_inputs(E, share)
        for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            args = [torch.tensor(a, dtype=dt, device=dev) for a in inputs]
            got = p2c_edge_terms(*args)
            want = p2c_edge_terms_plain(*args)
            abs_err, rel_err = compare(torch, f"K1 {str(dt)[6:]} E={E}", got, want, tol,
                                       ("chi2", "hdiag", "g_cam", "g_pt", "hcc", "hcp", "hpp"))
            ms = cuda_ms(torch, lambda: p2c_edge_terms(*args))
            one_ms = call_ms(torch, lambda: p2c_edge_terms(*args))
            plain_ms = call_ms(torch, lambda: p2c_edge_terms_plain(*args))
            size = args[0].element_size()
            bound_ms, bound_by = bound(E * 94 * size, E * P2C_FLOPS_PER_SLOT, size)
            gbs = E * 94 * size / (ms * 1e-3) / 1e9
            print(f"K1 p2c_edge_terms {str(dt)[6:]} E={E}: max abs err {abs_err:.3e}, "
                  f"max err/scale {rel_err:.3e} (tol {tol:g}); back to back {ms:.4f} ms "
                  f"({gbs:.0f} GB/s of inputs+outputs), bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / ms:.1%} of the bound; one call from idle {one_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
            numbers = dict(max_abs_err=abs_err, ms=one_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, ms_back_to_back=ms)
            if E == BENCH_E and dt == torch.float32:
                result = dict(name="p2c_edge_terms", route="cuda",
                              source="slam_plus_plus_tpu_torch/csrc/p2c.cu",
                              replaces="slam_plus_plus_tpu/ops/pallas_p2c.py:185",
                              launches=0, library_ms=None, launches_per_step=None,
                              venice_real={"E": VENICE_E, "launches": 0,
                                           "launches_per_iteration": None},
                              **numbers)
            elif E == VENICE_E:
                result["venice_real"][str(dt)[6:]] = numbers
            del args, got, want
    return result


def panel_inputs(torch, dev, dt, Nl, M, n_cams, seed, Bl=3, Bp=6):
    """Random K2 inputs in the solver's form: the H_pl blocks stored
    [Nl, M, Bp, Bl] and handed over as the transposed view [Nl, M, Bl, Bp];
    every landmark sees BENCH_MIN_OBS..M distinct cameras and pads the rest
    with zero blocks on its first camera, as the uniform layout does."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(BENCH_MIN_OBS, M + 1, Nl)
    rows = np.argsort(rng.random((Nl, n_cams)), axis=1)[:, :M].astype(np.int32)
    store = rng.normal(0, 1, (Nl, M, Bp, Bl))
    pad = np.arange(M)[None, :] >= counts[:, None]
    rows[pad] = np.broadcast_to(rows[:, :1], rows.shape)[pad]
    store[pad] = 0.0
    a = rng.normal(0, 1, (Nl, Bl, Bl))
    cinv = np.linalg.inv(a @ a.transpose(0, 2, 1) + np.eye(Bl)).reshape(Nl, Bl * Bl)
    u4 = torch.tensor(store, dtype=dt, device=dev).transpose(2, 3)
    return (u4, torch.tensor(rows, device=dev), torch.tensor(cinv, dtype=dt, device=dev),
            int(pad.any(1).sum()))


def panel_bound(Nl, M, n_cams, itemsize, Bl=3, Bp=6):
    """K2's bound: u4, rows and C^-1 read once and both panels written once;
    the operations are the slot sums of Ut and the products and sums of Wt."""
    out = Nl * Bl * n_cams * Bp
    nbytes = (Nl * M * Bl * Bp + Nl * Bl * Bl + 2 * out) * itemsize + Nl * M * 4
    return bound(nbytes, Nl * M * Bl * Bp + (2 * Bl - 1) * out, itemsize)


def kernel_phase_panels(torch, dev):
    from slam_plus_plus_tpu_torch.ops import panel
    from slam_plus_plus_tpu_torch.ops.panel import build_panels, build_panels_plain

    Bl, Bp = 3, 6
    result = None
    for Nl, M, n_cams in ((BENCH_NL, BENCH_M, N_CAMS), K2_WIDE):
        for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            size = torch.tensor([], dtype=dt).element_size()
            u, r, c, n_pad = panel_inputs(torch, dev, dt, Nl, M, n_cams, SEED + 1)
            check(not u.is_contiguous() and n_pad > 0, "K2 inputs: strided view with dummies")
            TL, W = panel.panel_tiling(Nl, M, Bl, Bp, n_cams, size)
            n_win = len(panel.panel_windows(n_cams, W))
            # the kernel's unaligned paths: landmark block ranges that start off
            # a 16-byte line, and panel rows whose offset mod 16 changes per row
            off16 = int((np.arange(Nl) * (M * Bl * Bp * size) % 16 != 0).sum())
            row_shift = n_cams * Bp * size % 16 != 0
            if (Nl, M, n_cams) == K2_WIDE and dt == torch.float32:
                check(off16 and row_shift, "K2 wide shape: no unaligned ranges or rows")
            got = build_panels(u, r, c, Bl, Bp, n_cams)
            torch.cuda.synchronize()
            want = build_panels_plain(u, r, c, Bl, Bp, n_cams)
            name = f"K2 {str(dt)[6:]} cams={n_cams}"
            abs_err, rel_err = compare(torch, name, got, want, tol, ("Ut", "Wt"))
            dense = build_panels(u.contiguous(), r, c, Bl, Bp, n_cams)
            check(all(torch.equal(g, d) for g, d in zip(got, dense)),
                  f"{name}: the strided view and a contiguous copy disagree")
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{name}: not bitwise equal to the plain version")
            ms = cuda_ms(torch, lambda: build_panels(u, r, c, Bl, Bp, n_cams))
            one_ms = call_ms(torch, lambda: build_panels(u, r, c, Bl, Bp, n_cams))
            plain_ms = call_ms(torch, lambda: build_panels_plain(u, r, c, Bl, Bp, n_cams))
            bound_ms, bound_by = panel_bound(Nl, M, n_cams, size)
            print(f"K2 build_panels {str(dt)[6:]} Nl={Nl} M={M} cams={n_cams} (TL={TL}, "
                  f"{n_win} window(s) of <= {W} cameras; {n_pad} landmarks with dummy "
                  f"slots on a camera they see; {off16} block ranges off a 16-byte line, "
                  f"row offsets shifting: {row_shift}): max abs err {abs_err:.3e}, max err/scale "
                  f"{rel_err:.3e} (tol {tol:g}), bitwise equal to plain; back to back "
                  f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} "
                  f"of the bound; one call from idle {one_ms:.4f} ms, plain {plain_ms:.4f} ms")
            if n_cams == N_CAMS and dt == torch.float32:
                result = dict(name="build_panels", route="cuda",
                              source="slam_plus_plus_tpu_torch/csrc/panel.cu",
                              replaces="slam_plus_plus_tpu/ops/pallas_panel.py:89",
                              launches=0, max_abs_err=abs_err, ms=one_ms,
                              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None, ms_back_to_back=ms, launches_per_step=None)
            del u, r, c, got, want, dense
    return result


def small_scene_check(torch, dev):
    """Assemble a small scene on the card in float32 and on the CPU in
    float64; the CPU path is held against the JAX package by the tests."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io import datasets
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
    from slam_plus_plus_tpu_torch.solvers.lm import damp_system

    path = os.path.join(_scene_dir(), "smoke_ba_10_300_5.txt")
    datasets.write_g2o_ba(path, *datasets.make_ba_scene(n_cams=10, n_points=300, seed=5))
    system = parse_g2o(path)
    worst = 0.0
    out = {}
    for d in ("cpu", dev):
        asm = Assembler(system, device=d)
        bs = asm.assemble(asm.snapshot_states(system))
        bs = damp_system(bs, bs.max_hdiag * 1e-3, asm.pp_diag_ids_dev)
        out[str(d)] = (bs, SchurSolver(asm).solve(bs))
    (ref, ref_dx), (got, got_dx) = out["cpu"], out[str(dev)]
    for name, w, g in zip(ref._fields, ref, got):
        w, g = w.double(), g.double().cpu()
        scale = max(float(w.abs().max()), 1.0)
        err = float((g - w).abs().max()) / scale
        check(err <= 1e-4, f"small scene {name}: {err:.3e} x scale")
        worst = max(worst, err)
    dx_err = max(float((g.double().cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                 for w, g in zip(ref_dx, got_dx))
    check(dx_err <= 1e-2, f"small scene damped step: {dx_err:.3e} relative")
    print(f"small scene (10 cams, 300 pts): card float32 vs CPU float64 block "
          f"system max err/scale {worst:.3e} (tol 1e-4), damped Schur step "
          f"{dx_err:.3e} relative (tol 1e-2)")


def _scene_dir():
    from slam_plus_plus_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    return _build.BUILD_DIR


def main_path(torch, dev, card, kernels):
    from slam_plus_plus_tpu_torch import bench
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    # the bench scene, cached beside the built kernels (bench.py caches it)
    t0 = time.perf_counter()
    path = bench.scene_path()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    system = parse_g2o(path)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the port's bench entry point's step (slam_plus_plus_tpu_torch/bench.py)
    step, states0 = bench.bench_step(system, dev)
    asm, schur, assemble_damped = step.asm, step.schur, step.assemble_damped
    t_plan = time.perf_counter() - t0
    print(f"bench scene: {system.num_vertices} vertices, {system.num_edges} edges; "
          f"Nl={asm.Nl} M={asm.M} slots={asm.Nl * asm.M} nred={schur.n_reduced}; "
          f"{asm.dtype}; host: scene {t_scene:.1f} s, parse {t_parse:.1f} s, "
          f"plan {t_plan:.1f} s")
    check(asm.dtype == torch.float32, "the card path runs float32")

    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # bench.py: one warm-up step (its result is dropped), then 4 timed steps
    t0 = time.perf_counter()
    _, chi2 = step(states0)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    states = states0
    before = (p2c_edge_terms.launches, build_panels.launches)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        states, chi2 = step(states)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    for k, b, n in zip(kernels, before, (p2c_edge_terms.launches, build_panels.launches)):
        k["launches_per_step"] = (n - b) / TIMED_STEPS
    final_chi2 = float(chi2)
    check(np.isfinite(final_chi2) and final_chi2 <= 1.05 * REF_FINAL_CHI2,
          f"chi2 after {TIMED_STEPS} steps {final_chi2:.2f} > 1.05 x {REF_FINAL_CHI2}")
    print(f"damped Schur step: {ms_iter:.3f} ms/iter over {TIMED_STEPS} steps "
          f"(first step {t_first * 1e3:.1f} ms) on {card}; chi2 after "
          f"{TIMED_STEPS} steps {final_chi2:.2f} <= 1.05 x {REF_FINAL_CHI2}")

    # stage split, synchronized around each stage
    stages = {k: [] for k in ("assemble", "panels", "sc_gemm", "cholesky", "update")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t) * 1e3)
        return out

    states = states0
    for _ in range(TIMED_STEPS):
        bs = timed("assemble", lambda: assemble_damped(states))
        c_inv, Ut, Wt = timed("panels", lambda: schur._uniform_panels(bs))
        sc, rhs = timed("sc_gemm", lambda: schur._reduce(bs, Ut, Wt))
        dx = timed("cholesky", lambda: schur._factor_solve(sc, rhs))
        states = timed("update", lambda: asm.update(
            states, *schur._back_substitute(bs, c_inv, Ut, dx)))
    split = {k: statistics.median(v) for k, v in stages.items()}
    print("stage split (median ms, synchronized): " +
          ", ".join(f"{k} {v:.3f}" for k, v in split.items()) +
          f"; sum {sum(split.values()):.3f}")

    # Lambda-LM through the CLI's code path
    args = cli.build_argparser().parse_args(["-i", path, "--device", dev.type, "-v", "-dx", ""])
    t0 = time.perf_counter()
    lm_chi2, lm_iters, _ = cli.run(args)
    t_lm = time.perf_counter() - t0
    check(np.isfinite(lm_chi2) and lm_chi2 <= 1.05 * REF_FINAL_CHI2,
          f"LM chi2 {lm_chi2:.2f} > 1.05 x {REF_FINAL_CHI2}")
    print(f"LM optimize(5, 0.01): chi2 {lm_chi2:.2f} in {lm_iters} iterations, "
          f"{t_lm:.2f} s wall with parse and set-up")

    launches = (p2c_edge_terms.launches, build_panels.launches)
    print(f"launches during the main path: p2c_edge_terms {launches[0]}, "
          f"build_panels {launches[1]}; per damped Schur step: p2c_edge_terms "
          f"{kernels[0]['launches_per_step']:g}, build_panels "
          f"{kernels[1]['launches_per_step']:g}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, n in zip(kernels, launches):
        check(n > 0, f"{k['name']} was not launched on the main path")
        k["launches"] = n
    bs = assemble_damped(states0)
    return step, states0, lambda: schur._uniform_panels(bs), split


def profile_steps(torch, step, states0, n_steps=TIMED_STEPS, what="steps"):
    """torch.profiler over n_steps steps (after one unprofiled warm-up).  Per
    iteration: device time of each kernel name, the sum of all device
    activity times, their union on the timeline (busy time), the wall time
    of the same profiled run and so the idle share."""
    from torch.profiler import ProfilerActivity, profile

    step(states0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = states0
        for _ in range(n_steps):
            states, _ = step(states)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    trace_summary(prof, n_steps, wall_ms, what)


def trace_summary(prof, n_steps, wall_ms, what):
    """Print a trace's device activities per iteration (of n_steps), their summed
    time, their union on the timeline (busy), the idle share of wall_ms
    (the run's wall time per iteration under the profiler) and the ten
    longest kernel names."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"device profile: the trace holds no device activity; busy time and "
              f"idle share not measured (wall {wall_ms:.3f} ms/iter under the profiler)")
        return
    per_name, busy_us, end_us = {}, 0.0, -1.0
    for a, b, name in spans:
        per_name[name] = per_name.get(name, 0.0) + (b - a)
        busy_us += max(0.0, b - max(a, end_us))
        end_us = max(end_us, b)
    sum_ms = sum(per_name.values()) / 1e3 / n_steps
    busy_ms = busy_us / 1e3 / n_steps
    print(f"device profile over {n_steps} {what}: {len(spans) / n_steps:.0f} device "
          f"activities per iteration; per iteration: wall {wall_ms:.3f} ms under the "
          f"profiler, sum of device activity times {sum_ms:.3f} ms, busy (union of their "
          f"intervals) {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.1%}")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        ms = us / 1e3 / n_steps
        print(f"  {ms:8.3f} ms/iter {ms / sum_ms:6.1%}  {name[:100]}")


def profile_panels_stage(torch, panels_stage):
    """torch.profiler over one panels stage of the bench step (C^-1 and K2):
    its device activities by name.  The panels come from K2 alone: no fill
    kernel may appear, and exactly one K2 launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    panels_stage()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        panels_stage()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    check(per_name, "the panels stage trace holds no device activity")
    print(f"panels stage profile: {sum(n for n, _ in per_name.values())} device activities, "
          f"{sum(us for _, us in per_name.values()) / 1e3:.4f} ms of device time")
    for name, (n, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {n:3d} x {us / 1e3:8.4f} ms  {name[:100]}")
    check(not any("fill" in name.lower() for name in per_name),
          "a fill kernel ran in the panels stage")
    check(sum(n for name, (n, _) in per_name.items() if "panel_kernel" in name) == 1,
          "the panels stage did not launch K2 exactly once")


def pose_dataset(name):
    """The acceptance row's file (io/acceptance.py), cached beside the
    built kernels."""
    from slam_plus_plus_tpu_torch.io import acceptance

    return acceptance.dataset(name, _scene_dir())


def small_pose_graph_check(torch, dev):
    """A small SE(2) and a small SE(3) graph assembled on the card in
    float32 and on the CPU in float64 (which the tests hold against the JAX
    package), at 1e-4 x scale per field of the block system."""
    from slam_plus_plus_tpu_torch.app import acceptance as acc
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o

    for name in ("se2", "se3"):
        path = os.path.join(_scene_dir(), f"smoke_{name}.g2o")
        if name == "se2":
            poses, edges = D.make_manhattan_2d(n_poses=300, seed=7, loop_prob=0.3)
            D.write_g2o_2d(path, edges, poses)
        else:
            poses, edges = D.make_sphere_3d(n_poses=200, seed=7)
            D.write_g2o_3d(path, edges, poses)
        system = parse_g2o(path)
        out = {}
        for d in ("cpu", dev):
            asm = Assembler(system, device=d)
            out[str(d)] = (asm, asm.assemble(asm.snapshot_states(system)))
        (_, ref), (asm, got) = out["cpu"], out[str(dev)]
        check(got.pp_blocks.dtype == torch.float32, f"small {name} graph: card dtype")
        worst = 0.0
        for field, w, g in zip(ref._fields, ref, got):
            w, g = w.double(), g.double().cpu()
            err = float((g - w).abs().max()) / max(float(w.abs().max()), 1.0)
            check(err <= 1e-4, f"small {name} graph {field}: {err:.3e} x scale")
            worst = max(worst, err)
        sym = acc.symmetry_residual(asm, got)
        check(sym == 0.0, f"small {name} graph: diagonal blocks not symmetric ({sym:.3e})")
        print(f"small {name.upper()} graph ({system.num_vertices} poses, {system.num_edges} "
              f"edges): card float32 vs CPU float64 block system max err/scale "
              f"{worst:.3e} (tol 1e-4); max |H - H^T| over diagonal blocks {sym:g}")


def small_landmark_check(torch, dev):
    """A small 2D landmark-SLAM graph, whose landmark class the auto rule
    splits off, solved by GN through the flat-layout Schur branch on the
    card (float32) and on the CPU (float64): the final chi2 within 1e-3
    relative.  The iteration counts are printed, not compared: a float32
    step may cross the |dx| threshold one iteration earlier."""
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver

    path = os.path.join(_scene_dir(), "smoke_landmark.g2o")
    _gp, _gl, pe, le = D.make_landmark_2d(n_poses=120, n_landmarks=60, world=15.0,
                                          obs_radius=4.0, seed=5)
    D.write_g2o_landmark_2d(path, pe, le)
    runs = {}
    for d in ("cpu", dev):
        gn = GaussNewtonSolver(parse_g2o(path), device=d)
        check(gn._schur is not None and not gn._schur.uniform,
              f"small landmark graph on {d}: not the flat Schur branch")
        runs[str(d)] = gn.optimize(5)
    (want, wit), (got, git) = runs["cpu"], runs[str(dev)]
    err = abs(got - want) / want
    check(err <= 1e-3,
          f"small landmark graph: card {got} in {git} iterations, CPU {want} in {wit}")
    print(f"small landmark graph ({gn.asm.Np} poses, {gn.asm.Nl} landmarks split off, "
          f"flat Schur): card float32 GN chi2 {got:.6f} in {git} iterations vs CPU "
          f"float64 {want:.6f} in {wit}, relative {err:.3e} (tol 1e-3)")


def manhattan_residual_check(torch, dev):
    """The manhattan3500 lambda solved on the card in float32
    (dtype=torch.float32, the JAX package's float32 path; the default is
    float64) by the block Cholesky and its PCG; the true residual
    ||b - lambda dx|| / ||b||, taken in float64 on the card, must be
    <= 1e-4.  Printed beside it, not gated: how far that step lies from the
    CPU's float64 step at the same point, whose lambda has soft modes
    float32 cannot resolve."""
    from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver

    path = pose_dataset("manhattan3500")
    gn = GaussNewtonSolver(parse_g2o(path), device=dev, dtype=torch.float32)
    asm = gn.asm
    check(gn._sparse_chol is not None and gn.pcg_iterations > 0,
          "manhattan3500 on the card: not the block Cholesky with PCG")
    bs = asm.assemble(asm.snapshot_states(gn.system))
    dx, _ = gn._solve(bs)
    bs64 = BlockSystem(*[x.double() for x in bs])
    zl = torch.zeros((max(asm.Nl, 1), asm.Bl), dtype=torch.float64, device=dev)
    r = bs64.eta_p - LambdaSpmv(asm)(bs64, dx.double(), zl)[0]
    rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bs64.eta_p))
    check(rel <= 1e-4, f"manhattan3500 solve: relative true residual {rel:.3e} > 1e-4")
    cpu = GaussNewtonSolver(parse_g2o(path), device="cpu")
    dx64, _ = cpu._solve(cpu.asm.assemble(cpu.asm.snapshot_states(cpu.system)))
    err = float(torch.linalg.vector_norm(dx.double().cpu() - dx64) / torch.linalg.vector_norm(dx64))
    print(f"manhattan3500 lambda on the card (float32, {asm.Np} x {asm.Bp} dims): block "
          f"Cholesky {gn._sparse_chol.n_levels} levels, bottom {gn._sparse_chol.plan.n_bottom} "
          f"blocks, PCG iterations {[int(t) for t in gn.pcg_taken]}; relative true residual "
          f"||b - lambda dx|| / ||b|| {rel:.3e} (tol 1e-4); |dx| {float(dx.norm()):.2f} "
          f"against the CPU float64 step's {float(dx64.norm()):.2f}, relative distance "
          f"{err:.3e}")


def row_gate(label, chi2, golden, start):
    """An acceptance row's gate (app/acceptance.py ``gate``), which must
    pass; returns the verdict to print before the gate."""
    from slam_plus_plus_tpu_torch.app import acceptance as acc

    passed, verdict = acc.gate(label, chi2, golden, start)
    check(passed, f"{label}: chi2 {chi2:.2f} {verdict} {acc.goldens.GATE} x {golden}")
    return verdict


def pose_row(torch, dev, card, name, flags, golden, float32_control=False):
    """One acceptance row through the acceptance runner's row code
    (app/acceptance.py ``pose_row``: the CLI's code path, then its timed
    steady iterations), which must pass.  Returns (the solver, its final
    states, the step function)."""
    from slam_plus_plus_tpu_torch.app import acceptance as acc

    row, solver, states, step = acc.pose_row(dev, card, name, flags, golden,
                                             float32_control=float32_control)
    check(row["passed"], f"{row['row']}: chi2 {row['chi2']:.2f}, golden {golden}")
    return solver, states, step


def pose_graph_phase(torch, dev, card):
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    small_pose_graph_check(torch, dev)
    small_landmark_check(torch, dev)
    manhattan_residual_check(torch, dev)
    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    steps = {}
    for name in acceptance.POSE_ROWS:
        flags, golden = acceptance.ROWS[name]
        steps[name] = pose_row(torch, dev, card, name, flags, golden)
    flags, golden = acceptance.ROWS["manhattan3500"]
    pose_row(torch, dev, card, "manhattan3500", flags, golden, float32_control=True)
    print(f"launches during the pose-graph rows: p2c_edge_terms {p2c_edge_terms.launches}, "
          f"build_panels {build_panels.launches} (no Pallas kernel lies on this path)")
    _solver, states, step = steps["city10k"]
    profile_steps(torch, step, states, n_steps=2, what="city10k GN iterations")


# ---- phase 8: the rest of batch BA -------------------------------------------

#: the small forced sparse-reduced scene (tests/test_torch_sparse_schur.py's)
CLIQUE_SCENE = dict(n_cams=24, n_points=400, obs_per_point=6, seed=5)
#: card float32 against the CPU float64 solve of the same scene: the JAX
#: package's float32 bottom factor adds a 1e-5 ridge to the equilibrated
#: matrix, which moves this scene's damped step by ~1e-3 x its scale
#: (ROADMAP.md Queue 3); card against CPU on the same float32 lambda: 1e-4
SPARSE_TOL_F64, SPARSE_TOL_F32 = 2e-3, 1e-4
INTRINSICS_GOLDEN = 20520.96      # the reference binary's (tests/test_model_families.py)


def sparse_schur_check(torch, dev):
    """The small scene's damped lambda solved by the sparse-reduced branch
    (forced with sparse_reduced_limit=1) on the card in float32, by the
    clique and the gathered path: against the CPU solve of the same float32
    lambda, and against the CPU float64 solve (held against the JAX package
    by the tests)."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler, BlockSystem
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
    from slam_plus_plus_tpu_torch.solvers.lm import damp_system

    path = os.path.join(_scene_dir(), "smoke_clique_24_400_6_5.g2o")
    D.write_g2o_ba(path, *D.make_ba_scene_large(**CLIQUE_SCENE))
    system = parse_g2o(path)
    sol = {}
    for d in ("cpu", dev):
        asm = Assembler(system, device=d)
        bs = asm.assemble(asm.snapshot_states(system))
        sol[str(d)] = (asm, damp_system(bs, bs.max_hdiag * 1e-3, asm.pp_diag_ids_dev))
    (asm64, bs64), (asm, bs) = sol["cpu"], sol[str(dev)]
    bs32_cpu = BlockSystem(*[x.cpu() for x in bs])
    check(bs.pp_blocks.dtype == torch.float32, "sparse scene: card dtype")
    for clique in (True, False):
        errs = []
        solvers = [SchurSolver(a, sparse_reduced_limit=1) for a in (asm, asm64)]
        for sch in solvers:
            check(sch.sparse_reduced and sch.clique, "sparse scene: branch or clique path")
            sch.clique = clique
        got = solvers[0].solve(bs)
        for ref, tol in ((solvers[1].solve(bs32_cpu), SPARSE_TOL_F32),
                         (solvers[1].solve(bs64), SPARSE_TOL_F64)):
            worst = 0.0
            for w, g in zip(ref, got):
                w, g = w.double(), g.double().cpu()
                check(bool(torch.isfinite(g).all()), "sparse scene: step not finite")
                worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
            check(worst <= tol, f"sparse scene {'clique' if clique else 'gathered'}: "
                                f"{worst:.3e} > {tol:g} x scale")
            errs.append(worst)
        print(f"sparse-reduced Schur, small scene ({asm.Np} cams, {asm.Nl} pts, "
              f"{'clique' if clique else 'gathered'} path, Ksc {solvers[0].Ksc}, "
              f"{solvers[0].reduced_chol.n_levels} MIS levels): card float32 damped step vs "
              f"the CPU's on the same float32 lambda {errs[0]:.3e} x scale (tol "
              f"{SPARSE_TOL_F32:g}); vs CPU float64 {errs[1]:.3e} x scale (tol {SPARSE_TOL_F64:g})")


def ba_family_rows(torch, dev):
    """Small intrinsics, stereo and spheron files through LM (float32 on
    the card), and a stereo and a mono BA file through -dl (float64 on the
    card, config.float64_dtype), by the CLI's code path on the card and on
    the CPU (float64): final chi2 within 1e-4 relative.  The dogleg's
    undamped GN step in float32 is not finite on mono BA and a draw on the
    stereo file (ROADMAP.md Queue 3), so its card path runs float64."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import datasets as D

    d = _scene_dir()
    cams, pts, obs = D.make_ba_scene(n_cams=8, n_points=150, seed=30)
    files = {"intrinsics": os.path.join(d, "smoke_bai.g2o"),
             "stereo": os.path.join(d, "smoke_bas.g2o"),
             "spheron": os.path.join(d, "smoke_sph.g2o"),
             "mono": os.path.join(d, "smoke_ba_8_200_31.g2o")}
    D.write_g2o_ba_intrinsics(files["intrinsics"], cams, pts, obs)
    D.write_g2o_ba_stereo(files["stereo"], cams, pts, D.make_ba_stereo_obs(cams, pts, seed=31))
    D.write_g2o_spheron(files["spheron"], *D.make_spheron_scene(seed=32))
    D.write_g2o_ba(files["mono"], *D.make_ba_scene(n_cams=8, n_points=200, seed=31))
    rows = (("intrinsics", []), ("stereo", []), ("spheron", []),
            ("stereo", ["-dl", "-mfnsi", "30"]), ("mono", ["-dl"]))
    for name, flags in rows:
        out = {}
        for device in ("cpu", dev.type):
            args = cli.build_argparser().parse_args(
                ["-i", files[name], "--device", device, "-s", "-dx", ""] + flags)
            out[device] = cli.run(args)
        (want, wit, _), (got, git, solver) = out["cpu"], out[dev.type]
        dl = "-dl" in flags
        dt = torch.float64 if dl else torch.float32
        check(solver.asm.dtype == dt, f"{name} {flags}: the card path runs {dt}")
        err = abs(got - want) / want
        label = f"{name} {' '.join(flags) or 'LM'}"
        check(np.isfinite(got), f"{label}: chi2 {got}")
        check(err <= 1e-4, f"{label}: card {got} vs CPU {want}, {err:.3e} relative")
        verdict = "tol 1e-4"
        if name == "intrinsics":
            check(got <= 1.05 * INTRINSICS_GOLDEN,
                  f"intrinsics: chi2 {got:.2f} > 1.05 x {INTRINSICS_GOLDEN}")
            verdict += f"; <= 1.05 x the reference's {INTRINSICS_GOLDEN}"
        print(f"BA family {label} ({solver.system.num_vertices} vertices, "
              f"{solver.system.num_edges} edges): card {str(dt)[6:]} chi2 {got:.6f} in {git} "
              f"iterations vs CPU float64 {want:.6f} in {wit}, relative {err:.3e} ({verdict})")


def venice_row(torch, dev, card, k1):
    """venice-real (871 cameras, 100,000 points, 800,000 observations; the
    reference's headline BA workload) through the CLI's code path: it must
    take the sparse-reduced Schur with its clique path, and LM's 5
    iterations must end at <= 1.05 x the reference binary's chi2.  Then the
    steady ms per LM iteration over 3 more iterations (as
    scripts/venice_real_tpu.py measures it), a stage split of one solve,
    peak device memory, a profile of one LM iteration, and the launch
    counters: K1 launched during the row, K2 not.  Returns the solved
    GraphSystem (host arrays: the solver's device buffers go with it)."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels
    from slam_plus_plus_tpu_torch.solvers.lm import damp_system

    flags, golden = acceptance.ROWS["venice-real"]
    t0 = time.perf_counter()
    path = acceptance.dataset("venice-real", _scene_dir())
    t_scene = time.perf_counter() - t0
    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    torch.cuda.reset_peak_memory_stats()
    args = cli.build_argparser().parse_args(
        ["-i", path, "--device", dev.type, "-v", "-dx", ""] + flags)
    t0 = time.perf_counter()
    chi2, iters, solver = cli.run(args)
    t_cli = time.perf_counter() - t0
    launches = (p2c_edge_terms.launches, build_panels.launches)
    asm, sch = solver.asm, solver._schur
    check(asm.dtype == torch.float32, "venice-real: the card path runs float32")
    check(sch is not None and sch.sparse_reduced, "venice-real: not the sparse-reduced Schur")
    check(sch.clique, "venice-real: the clique path did not engage")
    check(asm.pl_uniform is not None and asm.M == 8 and asm.Nl * asm.M == VENICE_E,
          "venice-real: not K1's uniform layout at M = 8 without dummies")
    traj = [e for (_n, e, _d) in solver.trial_log]
    check(np.isfinite(chi2) and chi2 <= acceptance.GATE * golden,
          f"venice-real: chi2 {chi2:.2f} > {acceptance.GATE} x {golden}")
    check(launches[0] > 0, "venice-real: K1 was not launched")
    check(launches[1] == 0, f"venice-real: K2 launched {launches[1]} times")
    print(f"venice-real ({solver.system.num_vertices} vertices, {solver.system.num_edges} "
          f"edges; {asm.Np} x {asm.Bp} + {asm.Nl} x {asm.Bl} dims): scene file "
          f"{t_scene:.1f} s, parse {solver.timing['parse']:.2f} s by the C++ reader (the "
          f"Python parser took 10.5 s in PRs 7 and 8), construct "
          f"{solver.timing['construct']:.1f} s, CLI path "
          f"{t_cli:.1f} s with parse; sparse_reduced {sch.sparse_reduced}, clique "
          f"{sch.clique} (M {sch.M}), Ksc {sch.Ksc}, MIS levels {sch.reduced_chol.n_levels}, "
          f"bottom blocks {sch.reduced_chol.plan.n_bottom}")
    print(f"venice-real LM: initial chi2 {solver.initial_chi2:.2f} (reference "
          f"{acceptance.VENICE_INITIAL_CHI2}); per iteration " +
          " / ".join(f"{e:.1f}" for e in traj) + " (reference " +
          " / ".join(f"{e:g}" for e in acceptance.VENICE_TRAJECTORY) +
          f"); final {chi2:.2f} in {iters} iterations <= {acceptance.GATE} x {golden} "
          f"(ratio {chi2 / golden:.6f}); optimize {solver.timing['optimize']:.2f} s")

    # steady rate: 3 more LM iterations from the solved states
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _chi2b, it2 = solver.optimize(3)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) / max(it2, 1) * 1e3

    # stage split of one solve at the solved states, synchronized per stage
    states = asm.snapshot_states(solver.system)
    base = asm.assemble(states)
    alpha = float(base.max_hdiag) * 1e-3
    stages = {k: [] for k in ("assemble", "w_rhs", "clique_index_add", "block_cholesky",
                              "back_substitute")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t) * 1e3)
        return out

    for _ in range(3):
        bs = timed("assemble", lambda: damp_system(asm.assemble(states), alpha,
                                                   asm.pp_diag_ids_dev))
        c_inv, u, w, rhs = timed("w_rhs", lambda: sch._sparse_w_rhs(bs))
        sc = timed("clique_index_add", lambda: sch._sparse_sc(bs, u, w))
        dx_p = timed("block_cholesky", lambda: sch._sparse_factor_solve(sc, rhs))
        timed("back_substitute", lambda: sch._sparse_back_substitute(bs, c_inv, u, dx_p))
        del bs, c_inv, u, w, rhs, sc, dx_p
    split = {k: statistics.median(v) for k, v in stages.items()}
    k1["venice_real"]["launches"] = launches[0]

    def step(st):
        """One LM trial (damp, solve, update, re-assembly, its host read)."""
        new, _sys, n, e, den = solver._trial(st, base, alpha)
        torch.stack([n, e, den]).tolist()
        return new, e

    before = p2c_edge_terms.launches
    step(states)
    k1["venice_real"]["launches_per_iteration"] = p2c_edge_terms.launches - before
    print(f"venice-real: {ms_iter:.2f} ms per LM iteration steady ({it2} iterations of "
          f"optimize(3), its set-up assemble and chi2 included) on {card}; stage split of "
          f"one solve (median of 3, synchronized, ms): " +
          ", ".join(f"{k} {v:.3f}" for k, v in split.items()) +
          f"; sum {sum(split.values()):.3f}; launches during the row: p2c_edge_terms "
          f"{launches[0]} ({k1['venice_real']['launches_per_iteration']} per LM "
          f"iteration), build_panels {launches[1]}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(torch, step, states, n_steps=1, what="venice-real LM iteration")
    return solver.system


# ---- phase 9: the rest of batch solving --------------------------------------

#: card float32 against CPU float64 on the small Sim(3) and ROCV scenes:
#: final chi2, relative (phase 7's landmark graph uses the same bound)
SMALL_TOL = 1e-3
#: the full-size Sim(3) inverse-distance BA: cameras, points, observations
#: per point (one LS edge from the owner, the rest LO edges)
SIM3_FULL = dict(n_cams=100, n_points=10000, n_obs=4, seed=61)
SIM3_SMALL = dict(n_cams=3, n_points=20, n_obs=3, seed=55)
#: timed LM trials of the full-size Sim(3) BA, after one warm-up
SIM3_STEPS = 5
ROCV_FULL_STEPS = 10000
#: chi2 per iteration may rise by float32's wander at the optimum only: the
#: JAX package's own float32 GN on a 3,500-step ROCV scene rises 7.0e-6 in
#: its last iteration, the port's 6.8e-5 (CPU, float32; ROADMAP.md Queue 3)
RISE_TOL = 1e-3


def sim3_scene(kind, **kw):
    """A Sim(3) scene (io/datasets.py builds it in code) as a GraphSystem."""
    from slam_plus_plus_tpu_torch.graph.system import GraphSystem
    from slam_plus_plus_tpu_torch.io import datasets as D

    make = D.make_sim3_chain if kind == "chain" else D.make_sim3_invdist_ba
    return D.fill_system(GraphSystem(), *make(**kw))


def _lm_accepted(solver):
    """chi2 after each LM iteration: a trial's chi2 where it was taken, the
    chi2 it started from where it was not (a last trial whose |dx| fell
    under the default threshold stopped the loop untaken)."""
    cur, out = solver.initial_chi2, []
    for (n, e, den) in solver.trial_log:
        if not np.isfinite(n) or n <= 0.01:
            break
        if den != 0.0 and (cur - e) / den > 0:
            cur = e
        out.append(cur)
    return out


def _not_rising(seq):
    return all(np.isfinite(seq)) and all(b <= a * (1 + RISE_TOL) for a, b in zip(seq, seq[1:]))


def small_sim3_rocv_check(torch, dev):
    """The Sim(3) chain (GN), the small inverse-distance Sim(3) BA (LM) and
    a small ROCV file (GN through the CLI's code path) on the card (float32)
    and on the CPU (float64), the same iterations: final chi2 within
    SMALL_TOL relative."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver, route_dtype
    from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

    rocv = os.path.join(_scene_dir(), "smoke_rocv_40.g2o")
    D.write_g2o_rocv(rocv, *D.make_rocv_scene(n_steps=40, seed=33))
    cases = (("Sim(3) chain, GN", lambda d: GaussNewtonSolver(sim3_scene("chain"), device=d)),
             ("Sim(3) inverse-distance BA, LM",
              lambda d: LevenbergMarquardtSolver(sim3_scene("invdist", **SIM3_SMALL), device=d)),
             ("ROCV, GN by the CLI's code path", lambda d: cli.run(cli.build_argparser().parse_args(
                 ["-i", rocv, "--device", d, "-s", "-dx", ""]))))
    for label, make in cases:
        runs = {}
        for d in ("cpu", dev.type):
            if label.startswith("ROCV"):
                chi2, iters, solver = make(d)
            else:
                solver = make(d)
                chi2, iters = solver.optimize(5)
            runs[d] = (chi2, iters, solver)
        (want, wit, _), (got, git, solver) = runs["cpu"], runs[dev.type]
        route = route_dtype(solver.system, dev, solver.settings)
        check(solver.asm.dtype == route, f"{label}: {solver.asm.dtype} on the card, not {route}")
        err = abs(got - want) / want
        check(np.isfinite(got) and err <= SMALL_TOL,
              f"{label}: card {got} in {git} iterations, CPU {want} in {wit}")
        print(f"small {label} ({solver.system.num_vertices} vertices, {solver.system.num_edges} "
              f"edges; {solver.asm.Np} x {solver.asm.Bp} + {solver.asm.Nl} x {solver.asm.Bl} dims): "
              f"card {str(route)[6:]} chi2 {got:.6f} in {git} iterations vs CPU float64 {want:.6f} in "
              f"{wit}, relative {err:.3e} (tol {SMALL_TOL:g})")


def sim3_float32_exp(torch, dev):
    """sim3.exp in float32 on the card against float64 on the CPU across
    its small-angle threshold (theta^2 < 1e-9 takes the Taylor branch; just
    above it 1 - cos theta rounds to 0 in float32): the translation's
    relative error per theta, printed for ROADMAP.md Queue 3; it must be
    finite."""
    from slam_plus_plus_tpu_torch.manifolds import sim3

    axis = np.array([0.4, -0.3, 0.2]) / np.linalg.norm([0.4, -0.3, 0.2])
    thetas = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 1e-2)
    out = []
    for lam in (0.0, 1e-3):
        xi = np.array([np.concatenate([[0.3, -0.2, 0.5], axis * th, [lam]]) for th in thetas])
        want = sim3.exp(torch.tensor(xi, dtype=torch.float64))[:, :3]
        got = sim3.exp(torch.tensor(xi, dtype=torch.float32, device=dev))[:, :3].double().cpu()
        check(bool(torch.isfinite(got).all()), "sim3.exp float32 on the card: not finite")
        err = ((got - want).norm(dim=1) / want.norm(dim=1)).tolist()
        out.append(f"lambda {lam:g}: " + ", ".join(f"{th:g} {e:.1e}" for th, e in zip(thetas, err)))
    print("sim3.exp, card float32 against CPU float64, relative error of t by theta: " +
          "; ".join(out))


def spcg_row(torch, dev, card):
    """city10k through SPCGSolver with the spanning-tree preconditioner, 5 GN
    iterations, gated as the row; then the steady ms per iteration, the
    time of one tree solve (one CG trip's preconditioner) and of one CG
    solve (200 trips)."""
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.spcg import SPCGSolver

    name, label = "city10k", "city10k SPCG"
    _flags, golden = acceptance.ROWS[name]
    path = pose_dataset(name)
    t0 = time.perf_counter()
    system = parse_g2o(path)
    t_parse = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sp = SPCGSolver(system, device=dev)
    t_construct = time.perf_counter() - t0
    check(sp.preconditioner == "subgraph", f"{label}: preconditioner {sp.preconditioner}")
    chi2, iters = sp.optimize(5)
    verdict = row_gate(label, chi2, golden, lambda: sp.iteration_log[0][0])
    asm = sp.asm
    states = asm.snapshot_states(sp.system)
    bs = asm.assemble(states)
    f = sp.tree_chol.factor(bs.pp_blocks[sp._tree_sel])
    tree_ms = cuda_ms(torch, lambda: sp.tree_chol.solve_with_factor(f, bs.eta_p), reps=20, rounds=3)
    cg_ms = call_ms(torch, lambda: sp._solve(bs), reps=3)

    def step(st):
        b = asm.assemble(st)
        dx_p, dx_l = sp._solve(b)
        torch.stack([b.chi2, torch.sum(dx_p * dx_p)]).tolist()
        return asm.update(st, dx_p, dx_l)

    step(states)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        step(states)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) / 2 * 1e3
    tc = sp.tree_chol
    print(f"pose row {label} (GN over CG, {sp.cg_iters} trips, spanning-tree preconditioner: "
          f"{len(sp.tree_pairs)} tree pairs, block Cholesky {tc.n_levels} MIS levels, bottom "
          f"{tc.plan.n_bottom} blocks; {asm.Np} x {asm.Bp} dims): chi2 {chi2:.2f} in {iters} "
          f"iterations {verdict} {acceptance.GATE} x {golden} (ratio {chi2 / golden:.4f}); "
          f"{ms_iter:.1f} ms/iteration steady (2 after a warm-up); one CG solve {cg_ms:.1f} ms, "
          f"one tree solve {tree_ms:.3f} ms back to back; parse {t_parse:.1f} s, construct "
          f"{t_construct:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {card}")


def sim3_full_size(torch, dev, card):
    """The Sim(3) inverse-distance BA at 100 cameras and 10,000 points (LS
    and LO edges) through LM on the card: chi2 per iteration finite and not
    rising, ms per iteration, peak device memory."""
    from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

    t0 = time.perf_counter()
    system = sim3_scene("invdist", **SIM3_FULL)
    t_scene = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    lm = LevenbergMarquardtSolver(system, device=dev)
    chi2, iters = lm.optimize(5)
    start, seq = lm.initial_chi2, _lm_accepted(lm)
    check(np.isfinite(chi2) and _not_rising([start] + seq) and chi2 < start,
          f"Sim(3) BA: chi2 per iteration {[start] + seq}")
    asm = lm.asm
    states = asm.snapshot_states(lm.system)
    base = asm.assemble(states)
    alpha = float(base.max_hdiag) * 1e-3

    def step(st):
        """One LM trial (damp, solve, update, re-assembly, its host read)."""
        new, _sys, n, e, den = lm._trial(st, base, alpha)
        torch.stack([n, e, den]).tolist()
        return new, e

    step(states)
    times = []
    for _ in range(SIM3_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(states)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    branch = ("flat Schur" if lm._schur is not None and not lm._schur.sparse_reduced
              else "sparse-reduced Schur" if lm._schur is not None else "no Schur")
    print(f"Sim(3) inverse-distance BA ({SIM3_FULL['n_cams']} cameras, {SIM3_FULL['n_points']} "
          f"points, {system.num_edges} LS + LO edges; {asm.Np} x {asm.Bp} + {asm.Nl} x {asm.Bl} "
          f"dims, {branch}): LM chi2 {start:.2f} -> " +
          " / ".join(f"{c:.2f}" for c in seq) + f" in {iters} iterations; one LM trial from the "
          f"final base {np.median(times):.1f} ms steady (median of {SIM3_STEPS} after a warm-up, "
          f"{min(times):.1f}-{max(times):.1f}); scene built in {t_scene:.1f} s, "
          f"construct {lm.timing['construct']:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {card}")
    profile_steps(torch, step, states, n_steps=1, what="Sim(3) BA LM iteration")


def rocv_full_size(torch, dev, card):
    """make_rocv_scene(n_steps=10000, n_transmitters=6) through the CLI's
    code path (GN): chi2 per iteration finite and not rising by more than
    RISE_TOL relative, ms per iteration, peak device memory."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import datasets as D

    path = os.path.join(_scene_dir(), f"smoke_rocv_{ROCV_FULL_STEPS}.g2o")
    t0 = time.perf_counter()
    D.write_g2o_rocv(path, *D.make_rocv_scene(n_steps=ROCV_FULL_STEPS, n_transmitters=6, seed=33))
    t_scene = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    chi2, iters, gn = cli.run(cli.build_argparser().parse_args(
        ["-i", path, "--device", dev.type, "-s", "-dx", ""]))
    seq = [c for c, _dx in gn.iteration_log] + [chi2]
    check(np.isfinite(chi2) and _not_rising(seq), f"ROCV: chi2 per iteration {seq}")
    asm = gn.asm
    chol = gn._sparse_chol
    branch = (f"block Cholesky, {chol.n_levels} MIS levels, bottom {chol.plan.n_bottom} blocks, "
              f"PCG iterations per solve {[int(t) for t in gn.pcg_taken]}" if chol is not None
              else "Schur" if gn._schur is not None else "dense")
    print(f"ROCV ({ROCV_FULL_STEPS} steps, 6 transmitters; {gn.system.num_vertices} vertices, "
          f"{gn.system.num_edges} edges; {asm.Np} x {asm.Bp} + {asm.Nl} x {asm.Bl} dims, {branch}): "
          f"GN chi2 " + " / ".join(f"{c:.2f}" for c in seq) + f" in {iters} iterations; "
          f"{gn.timing['optimize'] / iters * 1e3:.1f} ms per GN iteration (the CLI's optimize, "
          f"its first included); file {t_scene:.1f} s, parse {gn.timing['parse']:.1f} s, "
          f"construct {gn.timing['construct']:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {card}")


def rest_of_batch_phase(torch, dev, card):
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    small_sim3_rocv_check(torch, dev)
    sim3_float32_exp(torch, dev)
    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    for name in acceptance.REST_ROWS:
        flags, golden = acceptance.ROWS[name]
        pose_row(torch, dev, card, name, flags, golden)
    flags, golden = acceptance.ROWS["w100k"]
    pose_row(torch, dev, card, "w100k", flags, golden, float32_control=True)
    flags, golden = acceptance.ROWS["intel-scale"]
    pose_row(torch, dev, card, "intel-scale", ["-A"] + flags, golden)
    spcg_row(torch, dev, card)
    sim3_full_size(torch, dev, card)
    rocv_full_size(torch, dev, card)
    launches = (p2c_edge_terms.launches, build_panels.launches)
    check(launches == (0, 0), f"phase 9 launched K1/K2 {launches} times")
    print(f"launches during phase 9: p2c_edge_terms {launches[0]}, build_panels "
          f"{launches[1]} (no Pallas kernel lies on this path)")



# ---- phase 10: incremental solving -------------------------------------------

#: the small -fL replay of phase 10 (a): manhattan, no push before its first
#: dirty step, so card and CPU reach it at the same linearization
INCR_SMALL = dict(n_poses=300, seed=91)
#: the JAX package's float32 FastL replay of that file (its JAX engine, on
#: the CPU): float32 with the JAX package's settings ends 10.3% above the
#: float64 replay's 46.2038 there (ROADMAP.md Queue 3), and the port's
#: float32 replay follows the JAX one (tests/test_torch_incremental.py)
INCR_SMALL_JAX_F32 = 50.977749
#: the card's first dirty step against the same step on the CPU from the
#: same float32 inputs, per store x its scale; the final chi2 against the
#: JAX package's float32 replay, relative
INCR_STORE_TOL, INCR_CHI2_TOL = 1e-4, 1e-3
#: the profiled stretch of manhattan3500 -fL: this many solve points of the
#: fast path, from this one on
PROFILE_SOLVE_POINTS, PROFILE_FROM = 20, 100


def _first_dirty_step(torch, fl):
    """Keep host copies of the inputs and the result of the engine's first
    dirty step (the step updates the stores in place)."""
    seen = {}
    scan = fl.inc._dirty_scan

    def host(x):
        return x.detach().to("cpu", copy=True)

    def spy(stores, *a):
        first = "out" not in seen
        if first:
            seen["in"] = ({k: host(v) for k, v in stores.items()}, [host(x) for x in a])
        out = scan(stores, *a)
        if first:
            seen["out"] = {k: host(v) for k, v in out.items()}
        return out

    fl.inc._dirty_scan = spy
    return seen


def _store_errors(inc, got, want, tol=None):
    """max |got - want| / max(|want|, 1) of each flat store's data rows,
    checked against tol when one is given; returns them as text and the
    largest."""
    errs = {}
    for k, n in (("H", inc.KH), ("C", inc.NC), ("W", inc.NW), ("P", inc.NP)):
        w, g = want[k][:n].double(), got[k][:n].double()
        errs[k] = float((g - w).abs().max()) / max(float(w.abs().max()), 1.0)
        if tol is not None:
            check(errs[k] <= tol, f"small -fL replay: store {k} {errs[k]:.3e} x scale")
    return ", ".join(f"{k} {e:.2e}" for k, e in errs.items()), max(errs.values())


def incremental_small_check(torch, dev):
    """(a): the card's float32 -fL replay of a small manhattan: its first
    dirty step against the same step on the CPU from the same float32
    inputs, its DUMMY rows, its stores against the CPU float64 replay's
    (printed: the JAX package's float32 pivot ridge moves C by up to the
    pivot's condition x 1e-5), and its final chi2."""
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

    path = os.path.join(_scene_dir(), "smoke_manhattan_fastl.g2o")
    poses, edges = D.make_manhattan_2d(**INCR_SMALL)
    D.write_g2o_2d(path, edges, poses)
    runs = {}
    for d in ("cpu", dev):
        # the card's float32 engine (dtype=), against the CPU's float64 one
        fl = FastLSolver(parse_g2o(path), device=d,
                         dtype=torch.float32 if d == dev else None)
        seen = _first_dirty_step(torch, fl)
        chi2, iters = fl.run()
        check("out" in seen, f"small -fL replay on {d}: no dirty step")
        runs[str(d)] = (fl, seen, chi2, iters)
    (cpu, cseen, chi2_64, it64), (fl, seen, chi2, it) = runs["cpu"], runs[str(dev)]
    inc = fl.inc
    check(fl.asm.dtype == torch.float32 and cpu.asm.dtype == torch.float64,
          "small -fL replay: the card's float32 engine against the CPU's float64 one")
    check((inc.cap_d, inc.cap_e, inc.cap_w, inc.cap_p) ==
          (cpu.inc.cap_d, cpu.inc.cap_e, cpu.inc.cap_w, cpu.inc.cap_p),
          "small -fL replay: card and CPU capacities differ")
    stores, args = seen["in"]
    same, _ = _store_errors(inc, seen["out"], cpu.inc._dirty_scan(stores, *args),
                            INCR_STORE_TOL)
    for k, dummy in (("H", inc.H_dummy), ("C", inc.C_dummy), ("W", inc.W_dummy),
                     ("P", inc.P_dummy)):
        check(not bool(seen["out"][k][dummy].any()), f"small -fL replay: {k} DUMMY row written")
    vs64, vs64_max = _store_errors(inc, seen["out"], cseen["out"])
    rel = abs(chi2 - INCR_SMALL_JAX_F32) / INCR_SMALL_JAX_F32
    check(np.isfinite(chi2) and rel <= INCR_CHI2_TOL,
          f"small -fL replay: card {chi2} in {it} iterations, the JAX package's float32 "
          f"{INCR_SMALL_JAX_F32}")
    print(f"small -nsp 1 -fL replay (manhattan {INCR_SMALL['n_poses']} poses, "
          f"{len(fl.chol.plan.levels)} MIS levels): the first dirty step on the card against "
          f"the CPU's from the same float32 inputs, max err/scale {same} (tol "
          f"{INCR_STORE_TOL:g}); DUMMY rows zero; card float32 stores against the CPU float64 "
          f"replay's {vs64}, largest {vs64_max:.3e} x scale (not gated: the float32 pivot "
          f"ridge); final chi2 {chi2:.6f} in "
          f"{it} iterations vs the JAX package's float32 {INCR_SMALL_JAX_F32}, relative "
          f"{rel:.3e} (tol {INCR_CHI2_TOL:g}); the CPU float64 replay {chi2_64:.6f} in {it64} "
          f"(float32 {chi2 / chi2_64 - 1:+.2%}, as the JAX package's float32)")


def incremental_row(torch, dev, card, label):
    """One incremental acceptance row through the acceptance runner's row
    code (app/acceptance.py ``incremental_row``), which must pass; returns
    (chi2, ms per solve point, wall seconds of the CLI's run)."""
    from slam_plus_plus_tpu_torch.app import acceptance as acc

    row, _fl = acc.incremental_row(dev, card, label)
    check(row["passed"], f"{label}: chi2 {row['chi2']:.2f}, golden {row['golden']}")
    return row["chi2"], row["ms_per_solve_point"], row["wall_s"]


class _Profiled(Exception):
    """Ends a replay once its profiled stretch is over."""


def profile_solve_points(torch, dev, label):
    """torch.profiler over PROFILE_SOLVE_POINTS consecutive fast-path solve
    points of a fresh replay of the row (omega, dirty step, refined solve,
    the |dx| read and the host loop between them), from the
    PROFILE_FROM-th; the replay stops there."""
    from torch.profiler import ProfilerActivity, profile

    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

    name = acceptance.INCREMENTAL_ROWS[label][0]
    fl = FastLSolver(parse_g2o(pose_dataset(name)), device=dev)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    inner, seen = fl._solve_point, {"n": 0}

    def spy(*a):
        k = seen["n"]
        seen["n"] += 1
        if k == PROFILE_FROM:
            torch.cuda.synchronize()
            prof.__enter__()
            seen["t0"] = time.perf_counter()
        elif k == PROFILE_FROM + PROFILE_SOLVE_POINTS:
            torch.cuda.synchronize()
            seen["wall_ms"] = (time.perf_counter() - seen["t0"]) * 1e3 / PROFILE_SOLVE_POINTS
            prof.__exit__(None, None, None)
            raise _Profiled
        return inner(*a)

    fl._solve_point = spy
    try:
        fl.run()
    except _Profiled:
        pass
    check("wall_ms" in seen, f"{label}: fewer than {PROFILE_FROM + PROFILE_SOLVE_POINTS} "
          f"fast-path solve points")
    trace_summary(prof, PROFILE_SOLVE_POINTS, seen["wall_ms"], f"{label} solve points")


def incremental_phase(torch, dev, card):
    """Returns {row label: (chi2, ms per solve point, wall seconds)}."""
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    incremental_small_check(torch, dev)
    rows = {label: incremental_row(torch, dev, card, label)
            for label in acceptance.INCREMENTAL_ROWS}
    profile_solve_points(torch, dev, "manhattan3500 -nsp 1 -fL")
    launches = (p2c_edge_terms.launches, build_panels.launches)
    check(launches == (0, 0), f"phase 10 launched K1/K2 {launches} times")
    print(f"launches during phase 10: p2c_edge_terms {launches[0]}, build_panels "
          f"{launches[1]} (no Pallas kernel lies on this path)")
    return rows


# ---- phase 11: marginal covariances -------------------------------------------

#: (a) the small scenes of tests/test_torch_marginals.py: case -> (scene,
#: mode, chunk, gauge jitter, route).  Each route runs on the card from the
#: CPU's float64 lambda, so the comparison sees the recovery alone.
#: Sigma = lambda^-1 differs between two correct float64 inversions by up to
#: kappa x 2.2e-16 (kappa: the condition number of the diagonally
#: equilibrated lambda, 1e7-1e9 here), so the tolerance is
#: max(1e-10, kappa x eps)
MARG_SMALL = {
    "dense": ("manhattan60", "auto", None, 0.0, "dense"),
    "sparse": ("manhattan60", "sparse", None, 0.0, "sparse"),
    "schur_flat": ("landmark50_20", "auto", None, 0.0, "schur_flat"),
    "schur_flat_chunks_of_8": ("landmark50_30", "auto", 8, 0.0, "schur_flat"),
    "sparse_schur": ("landmark600_90", "sparse_schur", None, 0.0, "sparse_schur"),
    "ba_uniform": ("ba6_60", "auto", None, 1e-10, "schur_uniform"),
}
#: the gauge jitter of the BA rows (the JAX BA facade's, app/ba_optimizer.py:123)
BA_JITTER = 1e-10
#: (b) sampled vertices per pose row, and the gate against host splu columns
#: (tests/test_marginals.py:142-172): 1e-7 x scale, or kappa x 2.2e-16 where
#: the row's diagonally equilibrated lambda has a larger condition number
#: kappa (two correct float64 inversions differ by up to that much; on the
#: solved manhattan3500 and sphere2500 kappa is ~6e10 and host splu and a
#: dense Cholesky already differ by 1.0e-7 and 2.2e-7, my CPU runs)
MARG_SAMPLES, MARG_SPLU_TOL = 12, 1e-7
MARG_POSE_ROWS = ("manhattan3500", "city10k", "sphere2500")
#: (c) the two routes of a BA row against each other, x scale (stated in
#: PERF.md before the first run: the CPU read 7e-8 - 3.4e-7 on BA scenes of
#: 20-100 cameras at this jitter)
MARG_BA_TOL = 1e-5
#: (d) the last maintained diagonal against a recompute from the same
#: stores, and the final chi2 against the same row's in phase 10, relative
MARG_FASTL_TOL, MARG_CHI2_TOL = 1e-8, 1e-9
#: (d) every Woodbury update against a recompute from the same stores: the
#: JAX package's own bound for it (tests/test_fastl.py:103); an update and
#: a recompute of an ill-conditioned lambda (kappa ~5e10 on manhattan3500)
#: differ by 1e-9 - 1e-7 in float64, one update to the next
MARG_UPDATE_TOL = 1e-6
MARG_FASTL_ROWS = ("manhattan3500 -nsp 1 -fL", "intel-scale -nsp 1 -fL")
#: (e) the data-association demo's scene (app/dataassoc_example.py)
ASSOC_SPHERE = dict(n_poses=120, trans_noise=0.01, rot_noise=0.005, seed=4)


def _synced_ms(torch, fn, reps=3):
    """Median host ms of fn() over reps synchronized calls, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _l_real(l_diag, asm):
    """The real tangent dims of each landmark block, stacked (padded dims
    mean nothing)."""
    l_diag = l_diag.double().cpu().numpy()
    Bl = asm.Bl
    return np.concatenate([l_diag[c].reshape(Bl, Bl)[np.ix_(m, m)].ravel()
                           for c, m in enumerate(asm.l_mask.astype(bool)[:asm.Nl])])


def _marg_rel(got, want, asm):
    """(p_diag, l_diag's real dims): max |got - want| over the largest
    |want|."""
    gp, wp = got.p_diag.double().cpu(), want.p_diag.double().cpu()
    p = float((gp - wp).abs().max() / wp.abs().max())
    if not asm.Nl:
        return p, 0.0
    gl, wl = _l_real(got.l_diag, asm), _l_real(want.l_diag, asm)
    return p, float(np.abs(gl - wl).max() / np.abs(wl).max())


def _small_marginal_scenes():
    """The files of (a), written beside the built kernels."""
    from slam_plus_plus_tpu_torch.io import datasets as D

    d = _scene_dir()
    out = {name: os.path.join(d, f"marg_{name}.g2o") for name in
           ("manhattan60", "landmark50_20", "landmark50_30", "landmark600_90", "ba6_60",
            "held_out")}
    poses, edges = D.make_manhattan_2d(n_poses=60, seed=13)
    D.write_g2o_2d(out["manhattan60"], edges, poses)
    for name, kw in (("landmark50_20", dict(n_poses=50, n_landmarks=20, seed=14)),
                     ("landmark50_30", dict(n_poses=50, n_landmarks=30, seed=15)),
                     ("landmark600_90", dict(n_poses=600, n_landmarks=90, world=35.0,
                                             obs_radius=9.0, seed=17))):
        _gp, _gl, pe, le = D.make_landmark_2d(**kw)
        D.write_g2o_landmark_2d(out[name], pe, le)
    D.write_g2o_ba(out["ba6_60"], *D.make_ba_scene(n_cams=6, n_points=60, seed=2))
    # manhattan 150, seed 16, with its loop closures written last (the last
    # one is held out of the first lambda)
    poses, edges = D.make_manhattan_2d(n_poses=150, seed=16)
    odo = [e for e in edges if abs(e[1] - e[0]) == 1]
    clo = [e for e in edges if abs(e[1] - e[0]) != 1]
    with open(out["held_out"], "w") as f:
        for i, x in enumerate(poses):
            f.write(f"VERTEX2 {i} {x[0]:.10f} {x[1]:.10f} {x[2]:.10f}\n")
        for (i, j, z, info) in odo + clo:
            ut = [info[0, 0], info[0, 1], info[0, 2], info[1, 1], info[1, 2], info[2, 2]]
            f.write(f"EDGE2 {i} {j} " + " ".join(f"{v:.10f}" for v in z) + " " +
                    " ".join(f"{v:.10f}" for v in ut) + "\n")
    return out


def marginals_small_check(torch, dev):
    """(a): each Marginals route on the card against the CPU port on the
    CPU's float64 lambda; the card's own float64 assembly against the CPU's
    (through K1 on the BA scene, whose uniform route runs K2); and
    IncrementalMarginals' Woodbury update on the card against a recompute
    of the grown lambda."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler, BlockSystem
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.linalg import schur
    from slam_plus_plus_tpu_torch.linalg.bsr import partitioned_to_scipy
    from slam_plus_plus_tpu_torch.marginals import IncrementalMarginals, Marginals

    files = _small_marginal_scenes()
    for case, (scene, mode, chunk, jitter, route) in MARG_SMALL.items():
        system = parse_g2o(files[scene])
        cpu = Assembler(system, device="cpu")
        card = Assembler(system, device=dev, dtype=torch.float64)
        bs = cpu.assemble(cpu.snapshot_states(system))
        A = partitioned_to_scipy(cpu.pp_rows, cpu.pp_cols, bs.pp_blocks.numpy(), cpu.Np, cpu.Bp,
                                 cpu.pl_rows, cpu.pl_cols, bs.pl_blocks.numpy(),
                                 bs.ll_blocks.numpy(), cpu.Nl, cpu.Bl).toarray()
        A += np.eye(len(A)) * float(bs.max_hdiag) * jitter
        d = 1.0 / np.sqrt(np.diag(A))
        kappa = np.linalg.cond(A * d[:, None] * d[None, :])
        tol = max(1e-10, kappa * np.finfo(np.float64).eps)
        bs_card = card.assemble(card.snapshot_states(system))
        asm_err = max(float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1.0)
                      for g, w in zip(bs_card, bs))
        check(asm_err <= 1e-10, f"marginals {case}: card assembly {asm_err:.3e} x scale")
        pick = schur._pick_chunk
        if chunk:   # the flat panels cut at `chunk` landmarks
            schur._pick_chunk = lambda *_a: chunk
        margs = [Marginals(a, gauge_jitter=jitter, mode=mode) for a in (cpu, card)]
        schur._pick_chunk = pick
        check(not chunk or len(margs[1]._schur._flat_chunks()) >= 2,
              f"marginals {case}: one chunk")
        check(all(m.route == route for m in margs), f"marginals {case}: route {margs[1].route}")
        want = margs[0].compute(bs)
        got = margs[1].compute(BlockSystem(*[x.to(dev) for x in bs]))
        check(bool(torch.isfinite(got.p_diag).all() and torch.isfinite(got.l_diag).all()),
              f"marginals {case}: not finite")
        p_err, l_err = _marg_rel(got, want, cpu)
        check(p_err <= tol and l_err <= tol,
              f"marginals {case}: p_diag {p_err:.3e}, l_diag {l_err:.3e} > {tol:g} x scale")
        print(f"marginals (a) {case} ({scene}, route {route}): the card against the CPU port "
              f"on the same lambda, p_diag {p_err:.3e}, l_diag's real dims {l_err:.3e} x scale "
              f"(tol {tol:.1e}; kappa {kappa:.2e}); the card's float64 assembly {asm_err:.3e} "
              f"x scale (tol 1e-10)")

    system = parse_g2o(files["held_out"])
    asm = Assembler(system, device=dev, dtype=torch.float64)
    states = asm.snapshot_states(system)
    name = list(system.edge_stores)[0]
    n = system.edge_stores[name].n
    inc = IncrementalMarginals(asm)
    inc.compute(asm.assemble_active(states, {name: n - 1}, asm.Np, 0))
    G = IncrementalMarginals.omega_sqrt_for_edges(asm, states, name, [n - 1])
    got = inc.update(G)
    want = Marginals(asm).compute(asm.assemble_active(states, {name: n}, asm.Np, 0)).p_diag
    err = float((got - want).abs().max() / want.abs().max())
    check(err <= 1e-8, f"IncrementalMarginals.update on the card: {err:.3e} x scale")
    print(f"marginals (a) IncrementalMarginals: one Woodbury update (rank {G.shape[1]}) on the "
          f"card against a recompute of the grown lambda, {err:.3e} x scale (tol 1e-8)")


def marginals_pose_row(torch, dev, card, name):
    """(b): a pose row solved through the CLI's code path with -dm; the
    Sigma blocks of MARG_SAMPLES vertices against host splu columns of the
    same lambda; the recovery's ms and peak memory."""
    import scipy.sparse
    import scipy.sparse.linalg as spla

    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.linalg.bsr import partitioned_to_scipy

    flags, _golden = acceptance.ROWS[name]
    args = cli.build_argparser().parse_args(
        ["-i", pose_dataset(name), "--device", dev.type, "-s", "-dx", "", "-dm"] + flags)
    torch.cuda.reset_peak_memory_stats()
    _chi2, _iters, solver = cli.run(args)
    marg, bs, res, line = solver.marginals_report
    asm = marg.asm
    check(asm.dtype == torch.float64 and marg.route == "sparse",
          f"{name} -dm: {asm.dtype}, route {marg.route}")
    Np, Bp = asm.Np, asm.Bp
    A = partitioned_to_scipy(asm.pp_rows, asm.pp_cols, bs.pp_blocks.cpu().numpy(), Np, Bp)
    t0 = time.perf_counter()
    d = scipy.sparse.diags(1.0 / np.sqrt(A.diagonal()))
    eq = (d @ A @ d).tocsc()
    kappa = (spla.eigsh(eq, k=1, which="LA", return_eigenvectors=False)[0] /
             spla.eigsh(eq, k=1, sigma=0, which="LM", return_eigenvectors=False)[0])
    tol = max(MARG_SPLU_TOL, kappa * np.finfo(np.float64).eps)
    lu = spla.splu(A.tocsc())
    picks = np.random.default_rng(0).choice(Np, size=MARG_SAMPLES, replace=False)
    cols = np.zeros((Np * Bp, MARG_SAMPLES * Bp))
    for i, v in enumerate(picks):
        cols[v * Bp + np.arange(Bp), i * Bp + np.arange(Bp)] = 1.0
    S = lu.solve(cols)
    t_splu = time.perf_counter() - t0
    p_diag = res.p_diag.cpu().numpy()
    scale = np.abs(p_diag).max()
    err = max(np.abs(p_diag[v] - S[v * Bp:(v + 1) * Bp, i * Bp:(i + 1) * Bp].T.ravel()).max()
              for i, v in enumerate(picks)) / scale
    check(np.isfinite(err) and err <= tol,
          f"{name} -dm: sampled Sigma blocks {err:.3e} x scale from host splu (tol {tol:.1e})")
    ms = _synced_ms(torch, lambda: marg.compute(bs))
    chol = marg._sparse
    print(f"marginals (b) {name} ({Np} x {Bp} dims, float64; the CLI's -dm after "
          f"{' '.join(flags) or 'GN'}): route {marg.route}, {chol.n_levels} MIS levels, bottom "
          f"{chol.plan.n_bottom} blocks; {MARG_SAMPLES} sampled Sigma blocks against host splu "
          f"columns of the same lambda {err:.3e} x scale (tol {tol:.1e}: the equilibrated "
          f"lambda's kappa {kappa:.2e} x eps, at least {MARG_SPLU_TOL:g}; kappa and splu "
          f"{t_splu:.1f} s on the host); {ms:.2f} ms per recovery (median of 3 after a warm-up, "
          f"synchronized); printed '{line}'; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {card}")


def marginals_ba_row(torch, dev, card, label, system, route):
    """(c): a BA scene's float64 marginals at the gauge jitter, by its own
    route and by mode="sparse_schur"; the two must agree within MARG_BA_TOL
    on p_diag and on l_diag's real dims.  Returns the routes' ms."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.marginals import Marginals

    t0 = time.perf_counter()
    asm = Assembler(system, device=dev, dtype=torch.float64)
    bs = asm.assemble(asm.snapshot_states(system))
    t_asm = time.perf_counter() - t0
    out, line = {}, []
    for mode in ("auto", "sparse_schur"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        marg = Marginals(asm, gauge_jitter=BA_JITTER, mode=mode)
        t_plan = time.perf_counter() - t0
        res = marg.compute(bs)
        check(bool(torch.isfinite(res.p_diag).all() and torch.isfinite(res.l_diag).all()),
              f"{label} marginals ({marg.route}): not finite")
        ms = _synced_ms(torch, lambda: marg.compute(bs))
        peak = torch.cuda.max_memory_allocated() / 2**30
        sch = marg._schur
        shape = (f"{len(sch._flat_chunks())} chunks of {sch.chunk} landmarks"
                 if marg.route == "schur_flat" else
                 f"Ksc {sch.Ksc}, {len(sch.fill_pa)} observation pairs, "
                 f"{sch.reduced_chol.n_levels} MIS levels, bottom "
                 f"{sch.reduced_chol.plan.n_bottom}" if marg.route == "sparse_schur" else
                 "K1 + K2 panels")
        line.append(f"{marg.route} ({shape}): {ms:.1f} ms per recovery, plan {t_plan:.1f} s, "
                    f"peak {peak:.2f} GiB")
        out[marg.route] = (res, ms)
        del marg
    check(route in out, f"{label}: routes {list(out)}, not {route}")
    (a, _), (b, _) = out[route], out["sparse_schur"]
    p_err, l_err = _marg_rel(a, b, asm)
    check(p_err <= MARG_BA_TOL and l_err <= MARG_BA_TOL,
          f"{label} marginals: {route} against sparse_schur p_diag {p_err:.3e}, l_diag "
          f"{l_err:.3e} > {MARG_BA_TOL:g} x scale")
    print(f"marginals (c) {label} ({asm.Np} x {asm.Bp} + {asm.Nl} x {asm.Bl} dims, float64, "
          f"gauge jitter {BA_JITTER:g}; assemble {t_asm:.1f} s): " + "; ".join(line) +
          f"; {route} against sparse_schur: p_diag {p_err:.3e}, l_diag's real dims "
          f"{l_err:.3e} x scale (tol {MARG_BA_TOL:g}); Sigma_pp "
          f"{(asm.Np * asm.Bp) ** 2 * 8 / 1e6:.0f} MB; on {card}")
    return {r: ms for r, (_res, ms) in out.items()}


def marginals_fastl_row(torch, dev, card, label, phase10):
    """(d): the row's FastL replay with marginals=True, as the CLI builds
    it: the final chi2 against phase 10's run of the row without
    marginals; every Woodbury update, and the last maintained diagonal,
    each against a recompute from the stores it was taken at; the counts of
    update and recalculate and the ms per solve point with and without
    marginals (with them: the replay's seconds less the checks' own, each
    check timed between two synchronizations)."""
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

    name, flags, _golden, _iters = acceptance.INCREMENTAL_ROWS[label]
    check(flags[-3:] == ["-nsp", "1", "-fL"], f"{label}: not a -nsp 1 -fL row")
    t0 = time.perf_counter()
    fl = FastLSolver(parse_g2o(pose_dataset(name)), device=dev, every_n=1,
                     max_iterations=10, dx_threshold=20.0, marginals=True)
    update_errs, last = [], {"check_s": 0.0}

    def rel_to_recompute(stores):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fresh = fl.chol.marginals_from_stores(stores, fl.inc)[fl.chol._diag_pos0]
        err = float((fl._sigma_diag - fresh).abs().max() / fresh.abs().max())
        last["check_s"] += time.perf_counter() - t
        return err

    for attr in ("_sigma_update", "_sigma_recompute"):
        inner = getattr(fl, attr)

        def spy(stores, *a, inner=inner, attr=attr):
            inner(stores, *a)
            # read now: the dirty steps after it update the stores in place
            last["err"] = rel_to_recompute(stores)
            if attr == "_sigma_update":
                update_errs.append(last["err"])

        setattr(fl, attr, spy)
    torch.cuda.reset_peak_memory_stats()
    chi2, iters = fl.run()
    wall = time.perf_counter() - t0
    check(fl.asm.dtype == torch.float64, f"{label}: the incremental engine runs float64")
    chi2_10, ms_10, _wall = phase10[label]
    rel = abs(chi2 - chi2_10) / chi2_10
    check(rel <= MARG_CHI2_TOL, f"{label} with marginals: chi2 {chi2} against phase 10's "
          f"{chi2_10}, {rel:.3e} relative")
    check(last["err"] <= MARG_FASTL_TOL,
          f"{label}: the last maintained Sigma {last['err']:.3e} x scale from a recompute")
    worst = max(update_errs)
    check(worst <= MARG_UPDATE_TOL,
          f"{label}: a Woodbury update {worst:.3e} x scale from a recompute")
    st = fl.stats
    ms_point = (st["elapsed"] - last["check_s"]) / max(st["solve_points"], 1) * 1e3
    trace = fl.marginals_trace
    print(f"marginals (d) {label} with marginals=True: chi2 {chi2:.6f} in "
          f"{iters} iterations, phase 10's {chi2_10:.6f} ({rel:.1e} relative, tol "
          f"{MARG_CHI2_TOL:g}); {trace.count('update')} updates, "
          f"{trace.count('recalculate')} recalculates over {st['solve_points']} solve points; "
          f"the last maintained Sigma diagonal ({trace[-1]}) against a recompute from its "
          f"stores {last['err']:.3e} x scale (tol {MARG_FASTL_TOL:g}); every Woodbury update "
          f"against a recompute from its stores: median {statistics.median(update_errs):.3e}, "
          f"largest {worst:.3e}, {sum(e > MARG_FASTL_TOL for e in update_errs)} over "
          f"{MARG_FASTL_TOL:g} (tol {MARG_UPDATE_TOL:g}); {ms_point:.2f} ms per solve point "
          f"with marginals (the checks' {last['check_s']:.1f} s taken out), {ms_10:.2f} "
          f"without (phase 10); wall {wall:.1f} s with construction and the checks; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {card}")


def association_check(torch, dev):
    """(e): the data-association app on its demo sphere, on the card and on
    the CPU: the same decisions."""
    from slam_plus_plus_tpu_torch.app.dataassoc_example import run_association
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o

    path = os.path.join(_scene_dir(), "dataassoc_sphere120.g2o")
    poses, edges = D.make_sphere_3d(**ASSOC_SPHERE)
    D.write_g2o_3d(path, edges, poses)
    runs = {}
    for d in (dev, "cpu"):
        system = parse_g2o(path)
        n = len(system.vertex_order)
        cands = system.vertex_order[:-1][::max(1, n // 12)]
        t0 = time.perf_counter()
        decisions, sv = run_association(system, system.vertex_order[-1], cands, device=d)
        runs[str(d)] = (decisions, sv, time.perf_counter() - t0)
    (got, sv, t_card), (want, _cpu, t_cpu) = runs[str(dev)], runs["cpu"]
    check([ok for (_c, _m, ok, _d2) in got] == [ok for (_c, _m, ok, _d2) in want],
          "data association: the card's decisions differ from the CPU's")
    d2 = max(abs(g[3] - w[3]) / w[3] for g, w in zip(got, want))
    print(f"marginals (e) data association (sphere {ASSOC_SPHERE['n_poses']} poses): "
          f"{sum(ok for (_c, _m, ok, _d2) in got)}/{len(got)} candidates associated on the card "
          f"and on the CPU, the same decisions; squared distances {d2:.2e} relative apart; "
          f"{sv.marginals_trace.count('update')} updates; {t_card:.1f} s on the card, "
          f"{t_cpu:.1f} s on the CPU")


def marginals_phase(torch, dev, card, kernels, venice_system, phase10):
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    marginals_small_check(torch, dev)
    for name in MARG_POSE_ROWS:
        marginals_pose_row(torch, dev, card, name)
    before = (p2c_edge_terms.launches, build_panels.launches)
    bench = parse_g2o(os.path.join(_scene_dir(), f"bench_ba_{N_CAMS}_{N_POINTS}_{SCENE_SEED}.txt"))
    marginals_ba_row(torch, dev, card, "bench scene", bench, "schur_uniform")
    grew = (p2c_edge_terms.launches - before[0], build_panels.launches - before[1])
    check(all(g > 0 for g in grew), f"the bench scene's marginals launched K1/K2 {grew} times")
    print(f"marginals (c) bench scene: K1 launched {grew[0]}, K2 {grew[1]} times")
    del bench
    marginals_ba_row(torch, dev, card, "venice-real", venice_system, "schur_flat")
    for label in MARG_FASTL_ROWS:
        marginals_fastl_row(torch, dev, card, label, phase10)
    association_check(torch, dev)
    launches = (p2c_edge_terms.launches, build_panels.launches)
    for k, n in zip(kernels, launches):
        k["launches_marginals"] = n
    print(f"launches during phase 11: p2c_edge_terms {launches[0]}, build_panels {launches[1]}")



# ---- phase 12: incremental BA and online FastL -------------------------------

#: (a) the JAX test's incremental BA scene (tests/test_dogleg_incremental.py:21-29)
IBA_SMALL, IBA_SMALL_CHUNK = dict(n_cams=12, n_points=300, seed=5), 3
#: (b) the bench scene as a replay, two cameras per marker: 50 markers
IBA_CHUNK = 2
#: (a) per-marker chi2, card against CPU, relative: float64 on both reads
#: 6.3-6.6e-10 on the card (atomic index_add_, its order not fixed) and the
#: CPU port against the JAX package 1.8e-9 on the CPU, while the control,
#: the card's engine run in float32, reads ~1e2; (a, b) the maintained
#: lambda pieces and SC against a fresh assembly at the same states, x scale
#: (the JAX test's bound: the deltas are differences of large contributions)
IBA_CHI2_TOL, IBA_STATE_TOL = 1e-8, 1e-7
#: (b) the replay's final chi2 against the batch dogleg's on the full problem
#: (optimize(20, 1e-3), float64), the JAX test's bound
IBA_BATCH_GATE = 1.05
#: (b) the marginals' gauge damping, x the largest Hessian diagonal: at
#: 1e-10 both Schur-domain routes cancel the scale gauge's eigenvalue (~1e-4
#: from the true Sigma, tests/test_torch_marginals.py), at 1e-6 they agree
IBA_MARG_JITTER = 1e-6
#: (b) the markers profiled: the last three
IBA_PROFILE_MARKERS = 3
#: (c) the JAX test's no-growth stream (tests/test_fastl_online.py:25-42) and
#: its bounds: chi2 against the card's replay FastL, absolute; against the
#: CPU port's stream, relative
ONLINE_SMALL, ONLINE_SMALL_CAP = dict(n_poses=200, seed=3), 256
ONLINE_REPLAY_TOL, ONLINE_CPU_TOL = 1e-6, 1e-8
#: (c) the intel-scale stream: initial vertex capacity (the fringe holds
#: OnlineFastLSolver.FRINGE_CAP = 64 closures)
ONLINE_ROW, ONLINE_CAP = "intel-scale", 128
#: (d) -dsi: a small manhattan through the CLI's code path; the card's last
#: dump against the CPU's, x scale
DSI_SCENE, DSI_TOL = dict(n_poses=80, seed=12), 1e-8       # 7 loop closures


def _iba_file(name, chunk, **scene):
    """An incremental BA file (app/incremental_ba.py's layout), cached
    beside the built kernels."""
    from slam_plus_plus_tpu_torch.app.incremental_ba import write_incremental_ba
    from slam_plus_plus_tpu_torch.io import datasets as D

    path = os.path.join(_scene_dir(), name)
    if not os.path.exists(path):
        write_incremental_ba(path + ".tmp", *D.make_ba_scene(**scene), cams_per_chunk=chunk)
        os.replace(path + ".tmp", path)
    return path


def _maintained_errors(torch, s):
    """The maintained lambda pieces and SC of an IncrementalDoglegSolver
    against a fresh assembly at its states: ({name: max err / scale}, the
    fresh block system)."""
    bs = s.asm.assemble_active(s._states, s._counts, s._nap, s._nal)
    errs = {}
    for name, ref in (("pp", bs.pp_blocks), ("u", bs.pl_blocks), ("ll", bs.ll_blocks),
                      ("eta_p", bs.eta_p), ("eta_l", bs.eta_l), ("sc", s._build_sc(bs))):
        errs[name] = float((s._M[name] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    return errs, bs


def iba_small_check(torch, dev):
    """(a): the small scene replayed by the incremental dogleg on the card
    and on the CPU port, float64: per-marker chi2 and the card's maintained
    state against a fresh assembly; the control, the card's engine in
    float32, must read above the chi2 gate."""
    from slam_plus_plus_tpu_torch.app.incremental_ba import parse_with_markers
    from slam_plus_plus_tpu_torch.solvers import dogleg_incremental as DI

    path = _iba_file("iba_small.g2o", IBA_SMALL_CHUNK, **IBA_SMALL)

    def replay(d):
        system, markers = parse_with_markers(path)
        s = DI.IncrementalDoglegSolver(system, device=d)
        return s, s.run([m - 1 for m in markers])[1]

    (s, trace), (cpu, ctrace) = replay(dev), replay("cpu")
    engine_dtype = DI.float64_dtype
    DI.float64_dtype = lambda _d: torch.float32
    try:
        s32, trace32 = replay(dev)
    finally:
        DI.float64_dtype = engine_dtype
    check(s.asm.dtype == torch.float64 and s.asm.device.type == torch.device(dev).type
          and s32.asm.dtype == torch.float32,
          "small incremental BA: the card's engine runs float64 (the control float32)")
    check(len(trace) == len(ctrace) == len(trace32), "small incremental BA: marker counts differ")
    rel = [abs(a - b) / b for a, b in zip(trace, ctrace)]
    rel32 = max(abs(a - b) / b if np.isfinite(a) else np.inf for a, b in zip(trace32, ctrace))
    check(max(rel) <= IBA_CHI2_TOL, f"small incremental BA: per-marker chi2 card {trace} "
          f"against CPU {ctrace}, relative {rel}")
    check(not rel32 <= IBA_CHI2_TOL, f"small incremental BA: the float32 control reads "
          f"{rel32:.2e}, inside the gate {IBA_CHI2_TOL:g}")
    errs, _bs = _maintained_errors(torch, s)
    check(max(errs.values()) <= IBA_STATE_TOL,
          f"small incremental BA: maintained state against a fresh assembly {errs}")
    print(f"incremental BA (a) small scene ({IBA_SMALL['n_cams']} cameras, "
          f"{IBA_SMALL['n_points']} points, {len(trace)} markers): per-marker chi2 card "
          f"against CPU, largest {max(rel):.2e} relative (tol {IBA_CHI2_TOL:g}; the control, "
          f"the card's engine in float32, {rel32:.2e}); final {trace[-1]:.6f}; iterations "
          f"{s.stats['iters']} (CPU {cpu.stats['iters']}); the card's maintained state against "
          f"a fresh assembly: " + ", ".join(f"{k} {e:.1e}" for k, e in errs.items())
          + f" x scale (tol {IBA_STATE_TOL:g})")


def iba_full_row(torch, dev, card):
    """(b): the bench scene as an incremental replay through the dogleg on
    the card, float64, the last markers profiled; then its gates (the
    batch dogleg's chi2, the maintained state, the fluid savings), the
    maintained-state marginals against Marginals on a fresh assembly, and
    its times."""
    from torch.profiler import ProfilerActivity, profile

    from slam_plus_plus_tpu_torch.app.incremental_ba import parse_with_markers
    from slam_plus_plus_tpu_torch.config import SolverSettings
    from slam_plus_plus_tpu_torch.marginals import Marginals
    from slam_plus_plus_tpu_torch.solvers.dogleg import DoglegSolver
    from slam_plus_plus_tpu_torch.solvers.dogleg_incremental import IncrementalDoglegSolver

    t0 = time.perf_counter()
    path = _iba_file(f"iba_bench_{N_CAMS}_{N_POINTS}_{SCENE_SEED}.g2o", IBA_CHUNK,
                     n_cams=N_CAMS, n_points=N_POINTS, seed=SCENE_SEED)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    system, markers = parse_with_markers(path)
    t_parse = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = IncrementalDoglegSolver(system, device=dev)
    t_con = time.perf_counter() - t0
    prof_from = len(markers) - IBA_PROFILE_MARKERS
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    trace, per_marker, prof_s = [], [], 0.0
    for k, ms in enumerate(m - 1 for m in markers):
        if k == prof_from:
            torch.cuda.synchronize()
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it0 = s.stats["iters"]
        s.advance_to(ms)
        trace.append(s.optimize()[0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if k >= prof_from:
            prof_s += dt
        else:
            per_marker.append((dt, s.stats["iters"] - it0))
    prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    s.asm.writeback_states(system, s._states)
    final = trace[-1]
    errs, bs = _maintained_errors(torch, s)
    check(max(errs.values()) <= IBA_STATE_TOL,
          f"incremental BA bench replay: maintained state against a fresh assembly {errs}")
    total = sum(p.E for p in s.asm.plans)
    st = s.stats
    check(st["refreshed_edges"] < st["iters"] * total,
          f"incremental BA bench replay: {st['refreshed_edges']} edges refreshed in "
          f"{st['iters']} iterations of {total} edges")
    t0 = time.perf_counter()
    batch = DoglegSolver(parse_with_markers(path)[0], device=dev,
                         settings=SolverSettings(edge_layout="flat"), dtype=torch.float64)
    chi2_b, it_b = batch.optimize(20, 1e-3)
    t_batch = time.perf_counter() - t0
    check(np.isfinite(final) and final <= IBA_BATCH_GATE * chi2_b,
          f"incremental BA bench replay: final chi2 {final} against {IBA_BATCH_GATE} x the "
          f"batch dogleg's {chi2_b}; per-marker chi2 {trace}")
    alpha = float(bs.max_hdiag) * IBA_MARG_JITTER
    ms_maint = _synced_ms(torch, lambda: s.marginals(alpha=alpha))
    got = s.marginals(alpha=alpha)
    marg = Marginals(s.asm, gauge_jitter=IBA_MARG_JITTER)
    ms_batch = _synced_ms(torch, lambda: marg.compute(bs))
    p_err, l_err = _marg_rel(got, marg.compute(bs), s.asm)
    check(max(p_err, l_err) <= MARG_BA_TOL, f"incremental BA bench replay: maintained-state "
          f"marginals against Marginals ({marg.route}) p {p_err:.3e}, l {l_err:.3e} x scale")
    t_all, it_all = sum(d for d, _ in per_marker), sum(i for _, i in per_marker)
    print(f"incremental BA (b) the bench scene as a replay ({N_CAMS} cameras, {N_POINTS} "
          f"points, {total} observations, {len(markers)} markers of {IBA_CHUNK} cameras; "
          f"float64; scene {t_scene:.1f} s, parse {t_parse:.1f} s, construct {t_con:.1f} s): "
          f"final chi2 {final:.4f}, {final / chi2_b:.8f} x the batch dogleg's {chi2_b:.4f} "
          f"(gate {IBA_BATCH_GATE}; optimize(20, 1e-3), float64, flat layout, {it_b} "
          f"iterations, {t_batch:.1f} s); per-marker chi2 "
          f"{', '.join(f'{c:.6g}' for c in trace)}; {st['iters']} DL iterations over "
          f"{st['solves']} markers; {st['refreshed_edges']} edges refreshed "
          f"({st['refreshed_edges'] / total:.2f} x the whole graph; a full relinearization "
          f"every iteration: {st['iters']} x), {st['refreshed_lms']} landmarks re-eliminated; "
          f"markers 1-{prof_from}: {t_all * 1e3 / len(per_marker):.1f} ms per marker, "
          f"{t_all * 1e3 / max(it_all, 1):.1f} ms per DL iteration; the replay "
          f"{t_all + prof_s:.1f} s; peak device memory {peak:.3f} GiB; on {card}")
    print("  at the end: maintained state against a fresh assembly "
          + ", ".join(f"{k} {e:.1e}" for k, e in errs.items())
          + f" x scale (tol {IBA_STATE_TOL:g}); maintained-state marginals (gauge damping "
          f"{IBA_MARG_JITTER:g} x max diag) against Marginals ({marg.route}) on the fresh "
          f"assembly: p_diag {p_err:.2e}, l_diag {l_err:.2e} x scale (tol {MARG_BA_TOL:g}); "
          f"{ms_maint:.1f} ms per recovery from the maintained state, {ms_batch:.1f} ms by "
          f"Marginals")
    trace_summary(prof, IBA_PROFILE_MARKERS, prof_s * 1e3 / IBA_PROFILE_MARKERS,
                  f"markers ({prof_from + 1}-{len(markers)}; wall per marker)")


def _stream(torch, on, path):
    """Feed a pose file's edges one by one to an OnlineFastLSolver; returns
    (chi2, stats, wall seconds)."""
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o

    system = parse_g2o(path)
    store = system.edge_stores["edge_pose2d"]
    t0 = time.perf_counter()
    for (_en, li) in system._edge_insert_log:
        vids = store.vertex_ids[li]
        on.add_edge(int(vids[0]), int(vids[1]), store.measurements[li], store.informations[li])
    chi2, stats = on.finish()
    if on.device.type == "cuda":
        torch.cuda.synchronize()
    return chi2, stats, time.perf_counter() - t0


def online_fastl_check(torch, dev, card, replay_chi2):
    """(c): the no-growth stream on the card against the card's replay FastL
    and the CPU port's stream; the intel-scale file streamed edge by edge
    from a small capacity, against the rebuild bound and replay_chi2 (the
    row's -nsp 1 -fL replay, phase 10)."""
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
    from slam_plus_plus_tpu_torch.solvers.fastl_online import OnlineFastLSolver

    path = os.path.join(_scene_dir(), "online_manhattan200.g2o")
    poses, edges = D.make_manhattan_2d(**ONLINE_SMALL)
    D.write_g2o_2d(path, edges, poses)
    on = OnlineFastLSolver(device=dev, initial_capacity=ONLINE_SMALL_CAP)
    chi2, st, _wall = _stream(torch, on, path)
    check(on.fs.asm.dtype == torch.float64, "online FastL: the engine runs float64")
    replay, _it = FastLSolver(parse_g2o(path), device=dev).run()
    chi2_cpu, st_cpu, _w = _stream(torch, OnlineFastLSolver(
        device="cpu", initial_capacity=ONLINE_SMALL_CAP), path)
    check(st["rebuilds"] == 1, f"online FastL, no growth: {st['rebuilds']} rebuilds")
    check(abs(chi2 - replay) <= ONLINE_REPLAY_TOL,
          f"online FastL, no growth: chi2 {chi2} against the replay's {replay}")
    check(abs(chi2 - chi2_cpu) <= ONLINE_CPU_TOL * chi2_cpu,
          f"online FastL, no growth: chi2 {chi2} against the CPU port's {chi2_cpu}")
    counts = ("closures", "solves", "pushes")
    print(f"online FastL (c) manhattan {ONLINE_SMALL['n_poses']} poses from capacity "
          f"{ONLINE_SMALL_CAP} (no growth): chi2 {chi2:.8f}, the card's replay FastL "
          f"{replay:.8f} ({abs(chi2 - replay):.1e} apart, tol {ONLINE_REPLAY_TOL:g}), the CPU "
          f"port's stream {chi2_cpu:.8f} ({abs(chi2 - chi2_cpu) / chi2_cpu:.1e} relative, tol "
          f"{ONLINE_CPU_TOL:g}); " + ", ".join(f"{k} {st[k]} (CPU {st_cpu[k]})" for k in counts))

    path = pose_dataset(ONLINE_ROW)
    torch.cuda.reset_peak_memory_stats()
    on = OnlineFastLSolver(device=dev, initial_capacity=ONLINE_CAP)
    fringe = on.FRINGE_CAP
    chi2, st, wall = _stream(torch, on, path)
    n = on.n_vertices
    bound = (int(np.ceil(np.log2(n / ONLINE_CAP))) + 1
             + int(np.ceil(st["closures"] / fringe)) + 1)
    check(st["rebuilds"] <= bound, f"online FastL {ONLINE_ROW}: {st['rebuilds']} rebuilds "
          f"over the bound {bound}")
    check(np.isfinite(chi2) and chi2 <= 1.3 * replay_chi2 + 10.0,
          f"online FastL {ONLINE_ROW}: chi2 {chi2} against 1.3 x the replay's {replay_chi2} + 10")
    print(f"online FastL (c) {ONLINE_ROW} streamed edge by edge ({n} poses, {st['steps']} edges; "
          f"capacity {ONLINE_CAP} -> {on.capacity}, fringe {fringe}): chi2 {chi2:.4f}, "
          f"the -nsp 1 -fL replay's {replay_chi2:.4f} (ratio {chi2 / replay_chi2:.4f}; gate "
          f"1.3 x + 10); {st['rebuilds']} rebuilds (bound {bound}) taking "
          f"{st['rebuild_seconds']:.1f} s, {st['closures']} closures, {st['solves']} solve "
          f"points, {st['pushes']} pushes; {wall * 1e3 / st['steps']:.2f} ms per edge, "
          f"{st['solve_seconds'] * 1e3 / max(st['solves'], 1):.2f} ms per solve point; wall "
          f"{wall:.1f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; on {card}")


def dump_each_step_check(torch, dev):
    """(d): -dsi on a small manhattan with -nsp 1 through the CLI's code path
    on the card and on the CPU: the same dumps, the card's last equal to its
    -dx file and within DSI_TOL of the CPU's last."""
    import shutil

    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import datasets as D

    d = _scene_dir()
    path = os.path.join(d, "dsi_manhattan.g2o")
    poses, edges = D.make_manhattan_2d(**DSI_SCENE)
    D.write_g2o_2d(path, edges, poses)
    runs = {}
    for device in (dev.type, "cpu"):
        ddir, sol = os.path.join(d, f"dsi_{device}"), os.path.join(d, f"dsi_{device}.txt")
        shutil.rmtree(ddir, ignore_errors=True)
        args = cli.build_argparser().parse_args(
            ["-i", path, "--device", device, "-s", "-nsp", "1", "-dx", sol, "-dsi", ddir])
        chi2, iters, solver = cli.run(args)
        check(solver._delegate is None and iters > 0,
              f"-dsi on {device}: not the own path, or no iteration ({iters})")
        names = sorted(os.listdir(ddir))
        runs[device] = (names, np.loadtxt(os.path.join(ddir, names[-1])), np.loadtxt(sol),
                        chi2, solver.system.num_edges)
    (names, last, sol, chi2, n_edges), (cnames, clast, _csol, cchi2, _n) = (
        runs[dev.type], runs["cpu"])
    check(names == cnames and len(names) == n_edges,
          f"-dsi: {len(names)} dumps on the card, {len(cnames)} on the CPU, {n_edges} steps")
    check(np.array_equal(last, sol), "-dsi: the card's last dump differs from its -dx file")
    err = float(np.abs(last - clast).max() / max(np.abs(clast).max(), 1.0))
    check(err <= DSI_TOL, f"-dsi: the card's last dump {err:.3e} x scale from the CPU's")
    print(f"-dsi (d) manhattan {DSI_SCENE['n_poses']} poses, -nsp 1, through the CLI's code "
          f"path: {len(names)} dumps on the card and on the CPU (one per step); the card's "
          f"last dump equals its -dx file and lies {err:.1e} x scale from the CPU's (tol "
          f"{DSI_TOL:g}); chi2 {chi2:.6f} (CPU {cchi2:.6f})")


def incremental_ba_phase(torch, dev, card, intel_fl_chi2):
    """Phase 12; intel_fl_chi2: phase 10's intel-scale -nsp 1 -fL chi2."""
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    iba_small_check(torch, dev)
    iba_full_row(torch, dev, card)
    online_fastl_check(torch, dev, card, intel_fl_chi2)
    dump_each_step_check(torch, dev)
    launches = (p2c_edge_terms.launches, build_panels.launches)
    check(launches == (0, 0), f"phase 12 launched K1/K2 {launches} times")
    print(f"launches during phase 12: p2c_edge_terms {launches[0]}, build_panels "
          f"{launches[1]} (no Pallas kernel lies on this path)")


# ---- phase 13: the native host code, the facade, the C API, -rmut / -v -------

#: (b) the incremental rows the C++ engine replays on the card host's CPU
#: (--device cpu --native), each gated as in phase 10
NATIVE_ROWS = ("manhattan3500 -nsp 1 -fL", "intel-scale -nsp 1 -fL", "vp-scale -nsp 1 -fL",
               "manhattan3500 -nsp 1", "city10k -nsp 1", "trees10k-incr -nsp 1 -fL")
#: (b) the small replay, C++ engine against the torch engine on the CPU:
#: equal iterations and pushes, chi2 relative (tests/test_fastl.py:185-222)
NATIVE_SMALL, NATIVE_TORCH_TOL = dict(n_poses=300, seed=92, loop_prob=0.3), 1e-6
#: the Python parser's venice-real parse on the card's host (PRs 7 and 8)
VENICE_PY_PARSE_S = 10.5


def host_cpu():
    """The host CPU as lscpu names it, and /proc/cpuinfo's vendor, family,
    model and name of its first CPU."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    lscpu = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                  if ln.startswith("Model name")), "not reported")
    info = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            if not ln.strip():
                break
            k, _, v = ln.partition(":")
            info[k.strip()] = v.strip()
    return (f"lscpu model name {lscpu!r}; /proc/cpuinfo: " +
            ", ".join(f"{k} {info.get(k, 'not reported')!r}"
                      for k in ("vendor_id", "cpu family", "model", "model name")) +
            f"; {os.cpu_count()} logical CPUs")


def _same_system(a, b, what):
    """Two GraphSystems hold the same graph: vertex order, insertion log and
    every store exactly (tests/test_native_parser.py's checks, exact)."""
    check(a.vertex_order == b.vertex_order, f"{what}: vertex order")
    check(a._edge_insert_log == b._edge_insert_log, f"{what}: edge insertion log")
    check(set(a.vertex_stores) == set(b.vertex_stores) and
          set(a.edge_stores) == set(b.edge_stores), f"{what}: types")
    for t, sa in a.vertex_stores.items():
        check(np.array_equal(sa.data, b.vertex_stores[t].data), f"{what}: {t} states")
    for t, ea in a.edge_stores.items():
        eb = b.edge_stores[t]
        check(ea.n == eb.n and all(np.array_equal(getattr(ea, f)[:ea.n], getattr(eb, f)[:eb.n])
                                   for f in ("vertex_ids", "measurements", "informations")),
              f"{what}: {t} edges")


def reader_check(host):
    """(a): venice-real and the bench scene by the Python parser and the
    C++ reader, equal systems, each reader's seconds."""
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.ops import _build

    lib, t_build = _build.build_host("reader", force=True)
    print(f"(a) the C++ reader: g++ build {t_build:.1f} s")
    for label, path in (("venice-real", acceptance.dataset("venice-real", _scene_dir())),
                        ("bench scene", os.path.join(
                            _scene_dir(), f"bench_ba_{N_CAMS}_{N_POINTS}_{SCENE_SEED}.txt"))):
        t0 = time.perf_counter()
        fast = parse_g2o_fast(path)
        t_fast = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = parse_g2o(path)
        t_py = time.perf_counter() - t0
        _same_system(fast, py, f"{label}: the C++ reader against the Python parser")
        print(f"(a) {label} ({py.num_vertices} vertices, {py.num_edges} edges): the C++ reader "
              f"{t_fast:.2f} s, the Python parser {t_py:.2f} s ({t_py / t_fast:.1f}x), equal "
              f"systems; host {host}")
        del fast, py


def native_small_check():
    """(b): a small replay by the C++ engine against the torch engine on
    the CPU."""
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

    path = os.path.join(_scene_dir(), "smoke_manhattan_native.g2o")
    poses, edges = D.make_manhattan_2d(**NATIVE_SMALL)
    D.write_g2o_2d(path, edges, poses)
    runs = []
    for native in (True, False):
        fl = FastLSolver(parse_g2o(path), device="cpu", native=native)
        chi2, iters = fl.run()
        runs.append((chi2, iters, fl.stats["pushes"]))
    (chi2, iters, pushes), (tchi2, titers, tpushes) = runs
    rel = abs(chi2 - tchi2) / tchi2
    check((iters, pushes) == (titers, tpushes) and rel <= NATIVE_TORCH_TOL,
          f"small replay: C++ engine {chi2} in {iters} ({pushes} pushes), torch engine {tchi2} "
          f"in {titers} ({tpushes})")
    print(f"(b) small -nsp 1 -fL replay (manhattan {NATIVE_SMALL['n_poses']}) on the CPU: C++ "
          f"engine {chi2:.6f} in {iters} iterations, {pushes} pushes; torch engine "
          f"{tchi2:.6f} in {titers}, {tpushes}; {rel:.1e} relative (tol {NATIVE_TORCH_TOL:g})")


def native_row(label, phase10, host, card):
    """(b): one incremental row through the CLI's code path with --device
    cpu --native, gated as in phase 10, beside phase 10's card reading of
    the same row in this run (phase10: {label: (chi2, ms per solve point,
    wall)}, empty when phase 13 runs alone)."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

    name, flags, golden, golden_iters = acceptance.INCREMENTAL_ROWS[label]
    args = cli.build_argparser().parse_args(
        ["-i", pose_dataset(name), "--device", "cpu", "--native", "-s", "-dx", ""] + flags)
    t0 = time.perf_counter()
    chi2, iters, solver = cli.run(args)
    wall = time.perf_counter() - t0
    fl = getattr(solver, "_delegate", None) or solver
    check(isinstance(fl, FastLSolver) and fl._native is not None,
          f"{label} --native: not the C++ engine")
    check(np.isfinite(chi2) and chi2 <= acceptance.GATE * golden,
          f"{label} --native: chi2 {chi2:.2f} > {acceptance.GATE} x {golden}")
    st = fl.stats
    ms_point = st["elapsed"] / max(st["solve_points"], 1) * 1e3
    if label in phase10:
        _chi2_10, ms_10, wall_10 = phase10[label]
        card_reading = (f"the card engine in phase 10 of this run: wall {wall_10:.1f} s, "
                        f"{ms_10:.2f} ms per solve point ({wall_10 / wall:.1f}x the host's wall)")
    else:
        card_reading = "the card engine: phase 10 not run in this call"
    print(f"(b) {label} --device cpu --native: chi2 {chi2:.2f} in {iters} iterations, "
          f"{st['pushes']} pushes <= {acceptance.GATE} x {golden} (ratio {chi2 / golden:.4f}; "
          f"the reference {golden} in {golden_iters}); wall {wall:.2f} s (parse "
          f"{fl.timing['parse']:.2f} s, construct {fl.timing['construct']:.2f} s, replay "
          f"{st['elapsed']:.2f} s), {st['solve_points']} solve points, {ms_point:.2f} ms per "
          f"solve point; {card_reading}; host {host}; card {card}")


def _bench_scene_values():
    """The bench scene as write_g2o_ba writes it (the same rounding), so the
    facade holds the file's graph: cameras, points, observations."""
    from slam_plus_plus_tpu_torch.io import datasets as D

    cams, pts, obs = D.make_ba_scene(n_cams=N_CAMS, n_points=N_POINTS, seed=SCENE_SEED)
    rng = np.random.default_rng(1)
    r10 = lambda v: float(f"{v:.10f}")     # noqa: E731
    cams = [([r10(v) for v in pos], [r10(v) for v in q], fx, fy, cx, cy, d)
            for (pos, q, fx, fy, cx, cy, d) in cams]
    pts = [[r10(v) for v in pt + rng.normal(0, 0.05, 3)] for pt in pts]
    return cams, pts, [(pid, cid, r10(u), r10(v)) for (pid, cid, u, v) in obs]


def facade_check(torch, dev, card, kernels):
    """(c): the bench scene fed to BAOptimizer(device="cuda") one call at
    a time, equal to the parsed file; LM optimize(5) gated as phase 4's,
    launching K1 and K2; covariances() against the sparse-reduced Schur
    route on the same states at phase 11's tolerance."""
    from slam_plus_plus_tpu_torch.app.ba_optimizer import BAOptimizer
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.marginals import Marginals
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    cams, pts, obs = _bench_scene_values()
    eye = np.eye(2)
    opt = BAOptimizer(device=dev)
    t0 = time.perf_counter()
    for c, (pos, q, fx, fy, cx, cy, d) in enumerate(cams):
        opt.add_cam_vertex_g2o(c, pos, q, fx, fy, cx, cy, d)
    for p, pt in enumerate(pts):
        opt.add_xyz_vertex(N_CAMS + p, pt)
    for (pid, cid, u, v) in obs:
        opt.add_p2c_edge(N_CAMS + pid, cid, (u, v), eye)
    t_feed = time.perf_counter() - t0
    _same_system(opt.system, parse_g2o_fast(os.path.join(
        _scene_dir(), f"bench_ba_{N_CAMS}_{N_POINTS}_{SCENE_SEED}.txt")),
        "(c) the fed facade against the parsed bench file")

    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chi2, iters = opt.optimize(5)
    torch.cuda.synchronize()
    t_lm = time.perf_counter() - t0
    launches = (p2c_edge_terms.launches, build_panels.launches)
    check(np.isfinite(chi2) and chi2 <= 1.05 * REF_FINAL_CHI2,
          f"(c) facade LM chi2 {chi2:.2f} > 1.05 x {REF_FINAL_CHI2}")
    check(all(n > 0 for n in launches), f"(c) facade LM launched K1/K2 {launches} times")
    for k, n in zip(kernels, launches):
        k["launches_facade"] = n

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = opt.covariances()
    torch.cuda.synchronize()
    ms_cov = (time.perf_counter() - t0) * 1e3
    asm = Assembler(opt.system, device=dev, dtype=torch.float64)
    bs = asm.assemble(asm.snapshot_states(opt.system))
    check(Marginals(asm, gauge_jitter=BA_JITTER).route == "schur_uniform",
          "(c) covariances(): not the uniform Schur route")
    ref = Marginals(asm, gauge_jitter=BA_JITTER, mode="sparse_schur").compute(bs)
    p_err, l_err = _marg_rel(res, ref, asm)
    check(p_err <= MARG_BA_TOL and l_err <= MARG_BA_TOL,
          f"(c) covariances() against sparse_schur: p_diag {p_err:.3e}, l_diag {l_err:.3e}")
    print(f"(c) BAOptimizer(device={dev.type!r}) fed the bench scene ({opt.n_vertices()} "
          f"vertices, {opt.n_edges()} edges) one call at a time in {t_feed:.1f} s, equal to "
          f"the parsed file; LM optimize(5): chi2 {chi2:.2f} in {iters} iterations <= 1.05 x "
          f"{REF_FINAL_CHI2} (ratio {chi2 / REF_FINAL_CHI2:.6f}), {t_lm:.2f} s with set-up, "
          f"launching p2c_edge_terms {launches[0]}, build_panels {launches[1]} times; "
          f"covariances() (float64, uniform Schur route, K1 + K2) {ms_cov:.1f} ms with its "
          f"assembly and plan, against the sparse-reduced route p_diag {p_err:.3e}, l_diag's "
          f"real dims {l_err:.3e} x scale (tol {MARG_BA_TOL:g}); on {card}")


def c_api_check(card):
    """(d): the port's C API built, native/ba_c_test.c linked against it
    with gcc and run with SLAMPP_DEVICE unset (the card)."""
    from slam_plus_plus_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib, _ = _build.build_host("ba_c_api", force=True)
    t_build = time.perf_counter() - t0
    exe = os.path.join(_build.BUILD_DIR, "ba_c_test")
    t0 = time.perf_counter()
    cc = subprocess.run(["gcc", "-O2", os.path.join(REPO, "native", "ba_c_test.c"), "-o", exe,
                         lib, f"-Wl,-rpath,{os.path.dirname(lib)}"], capture_output=True, text=True)
    t_link = time.perf_counter() - t0
    check(cc.returncode == 0, f"(d) gcc native/ba_c_test.c: {cc.stderr}")
    env = {k: v for k, v in os.environ.items() if k != "SLAMPP_DEVICE"}
    env["SLAMPP_ROOT"] = REPO
    t0 = time.perf_counter()
    run = subprocess.run([exe], capture_output=True, text=True, timeout=600, env=env,
                         cwd=_scene_dir())
    t_run = time.perf_counter() - t0
    check(run.returncode == 0 and "C API OK" in run.stdout,
          f"(d) ba_c_test exit {run.returncode}: {run.stdout} {run.stderr[-2000:]}")
    print(f"(d) C API: g++ build {t_build:.1f} s, gcc link of native/ba_c_test.c {t_link:.1f} "
          f"s, run {t_run:.1f} s with SLAMPP_DEVICE unset (the card): "
          f"{' / '.join(run.stdout.split())}; on {card}")


def matrix_flags_check(dev, card):
    """(e): -rmut returns 0 and -rmb synthetic factor prints its sheet, on
    the card."""
    from slam_plus_plus_tpu_torch.app import main as cli

    t0 = time.perf_counter()
    rc = cli.main(["-rmut", "--device", dev.type, "-s"])
    t_ut = time.perf_counter() - t0
    check(rc == 0, f"(e) -rmut on {dev.type} returned {rc}")
    print(f"(e) -rmut --device {dev.type}: 0 in {t_ut:.2f} s; -rmb synthetic factor:")
    t0 = time.perf_counter()
    rc = cli.main(["-rmb", "synthetic", "factor", "--device", dev.type])
    check(rc == 0, f"(e) -rmb on {dev.type} returned {rc}")
    print(f"(e) -rmb: {time.perf_counter() - t0:.1f} s; on {card}")


def verbose_memory_check(torch, dev):
    """(f): one CLI run with -v on the card prints the memory line with the
    card's peak (reset just before the run)."""
    import contextlib
    import io

    from slam_plus_plus_tpu_torch.app import main as cli

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-i", os.path.join(_scene_dir(), "smoke_manhattan_native.g2o"), "-po",
                       "-v", "--device", dev.type, "-dx", ""])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("memory:")]
    check(rc == 0 and len(lines) == 1 and f"cuda:{dev.index}: " in lines[0] and "peak" in lines[0],
          f"(f) -v: no memory line with the card's peak in {buf.getvalue()[-800:]}")
    print(f"(f) -v --device {dev.type}: {lines[0]}")


def native_phase(torch, dev, card, kernels, phase10):
    host = host_cpu()
    print(f"phase 13 host: {host}; card: {card}")
    reader_check(host)
    native_small_check()
    for label in NATIVE_ROWS:
        native_row(label, phase10, host, card)
    facade_check(torch, dev, card, kernels)
    c_api_check(card)
    matrix_flags_check(dev, card)
    verbose_memory_check(torch, dev)


# ---- phase 14: the host tools and the two example apps ------------------------

EIG_K, EIG_MAX_ITERS, EIG_TOL = 6, 200, 1e-4     # the JAX test's tolerance for LOBPCG
POWER_ITERS = 1000
COND_SCENE = dict(n_poses=300, seed=3, loop_prob=0.3)     # the JAX test's graph
POLY_BATCH = 1 << 20
POLY_TOL = 1e-9
POLISH_ITERS = 6
RAW_MISS_FACTOR, RAW_MISS_SLACK = 2, 16
STRUCT_OBS, STRUCT_POINTS, STRUCT_TOL = 10000, 100, 1e-10
ACRA_TOL, FIT_TOL = 1e-6, 1e-8
VENICE_POINTS = 100000


def eigen_check(torch, dev, timer):
    """(a): the bench scene's float64 lambda on the card (K1), its top
    EIG_K eigenpairs by the port's LOBPCG, each pair's residual and the top
    eigenvalue against a power iteration.  Returns the assembler."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.linalg import eigen
    from slam_plus_plus_tpu_torch.utils.flops import torch_cost

    path = os.path.join(_scene_dir(), f"bench_ba_{N_CAMS}_{N_POINTS}_{SCENE_SEED}.txt")
    with timer.stage("eig asm"):
        graph = parse_g2o_fast(path)
        asm = Assembler(graph, device=dev, dtype=torch.float64)
        system = asm.assemble(asm.snapshot_states(graph))
    n = asm.Np * asm.Bp + asm.Nl * asm.Bl
    check(n > eigen._DENSE_LIMIT and asm.pl_uniform is not None,
          f"bench lambda: {n} dims, uniform layout {asm.pl_uniform is not None}")
    iters = []
    lobpcg = eigen.lobpcg_standard

    def counted(*a, **kw):
        out = lobpcg(*a, **kw)
        iters.append(out[2])
        return out

    eigen.lobpcg_standard = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer.stage("sym_eigs"):
            w, V = eigen.sym_eigs(asm, system, k=EIG_K, which="LM", max_iters=EIG_MAX_ITERS)
        t_eig = time.perf_counter() - t0
    finally:
        eigen.lobpcg_standard = lobpcg
    op = eigen.lambda_operator(asm, system)
    Vd = torch.as_tensor(V, device=dev)
    wd = torch.as_tensor(w, device=dev)
    resid = (torch.linalg.vector_norm(op(Vd) - Vd * wd[None, :], dim=0) / wd.abs()).cpu().numpy()
    check(bool(np.all(resid <= EIG_TOL)), f"(a) Ritz residuals {resid} > {EIG_TOL}")
    with timer.stage("power"):
        x = torch.as_tensor(np.random.default_rng(2).normal(size=(n, 1)), device=dev)
        for _ in range(POWER_ITERS):
            y = op(x)
            x = y / torch.linalg.vector_norm(y)
        top = float((x * op(x)).sum())
    err = abs(top - abs(w[0])) / abs(w[0])
    check(err <= EIG_TOL, f"(a) top eigenvalue {w[0]} vs power iteration {top}: {err:.3e}")
    cost = torch_cost(op, Vd)
    print(f"(a) sym_eigs(k={EIG_K}, 'LM') on the bench lambda ({n} dims, float64, "
          f"{asm.Kpp} pp / {asm.Kpl} pl blocks): {t_eig:.3f} s, {iters[0]} LOBPCG iterations, "
          f"{t_eig / max(iters[0], 1) * 1e3:.3f} ms per iteration (with the host's Rayleigh-Ritz "
          f"reads); eigenvalues {', '.join(f'{v:.6e}' for v in w)}; residual |Lv - wv|/|w| "
          f"max {resid.max():.3e} (tol {EIG_TOL:g}); power iteration ({POWER_ITERS}) "
          f"{top:.6e}, {err:.3e} relative (tol {EIG_TOL:g}); torch_cost of one lambda x "
          f"[{n}, {EIG_K}]: {cost['flops']:.4g} flops")
    return asm


def condition_check(torch, dev, timer):
    """(b): condition_estimate's dense and block Cholesky routes on the JAX
    test's manhattan 300 (within 5%), then the block Cholesky route on
    city10k.  Returns city10k's (assembler, block system)."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.linalg import eigen

    path = os.path.join(_scene_dir(), "smoke_cond_manhattan300.g2o")
    poses, edges = D.make_manhattan_2d(**COND_SCENE)
    D.write_g2o_2d(path, edges, poses)
    system = parse_g2o(path)
    asm = Assembler(system, device=dev, dtype=torch.float64)
    bs = asm.assemble(asm.snapshot_states(system))
    with timer.stage("cond"):
        dense = eigen.condition_estimate(asm, bs)
        limit, eigen._DENSE_LIMIT = eigen._DENSE_LIMIT, 10
        try:
            factor = eigen.condition_estimate(asm, bs)
        finally:
            eigen._DENSE_LIMIT = limit
    rel = abs(factor - dense) / dense
    check(rel < 0.05, f"(b) manhattan 300: factor route {factor:.6e} vs dense {dense:.6e}")
    system = parse_g2o(pose_dataset("city10k"))
    asm = Assembler(system, device=dev, dtype=torch.float64)
    bs = asm.assemble(asm.snapshot_states(system))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.stage("cond 10k"):
        kappa = eigen.condition_estimate(asm, bs)
    t_city = time.perf_counter() - t0
    check(np.isfinite(kappa) and kappa > 10.0, f"(b) city10k condition estimate {kappa}")
    print(f"(b) condition_estimate, manhattan 300 (900 dims, float64 on the card): dense "
          f"{dense:.6e}, block Cholesky route {factor:.6e}, {rel:.3e} relative (tol 0.05); "
          f"city10k ({asm.Np * asm.Bp} dims): {kappa:.6e} in {t_city:.2f} s (the block "
          f"Cholesky route, its factor and plan included)")
    return asm, bs


def nested_schur_check(dev, timer):
    """(c): the nested-Schur report of venice-real's structure."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.linalg.nested_schur import nested_schur_analysis

    with timer.stage("nested"):
        system = parse_g2o_fast(acceptance.dataset("venice-real", _scene_dir()))
        asm = Assembler(system, device=dev)
        report = nested_schur_analysis(asm)
    check(report[0]["kind"] == "landmarks" and report[0]["eliminated"] == VENICE_POINTS,
          f"(c) venice-real level 0: {report[0]}")
    print("(c) nested_schur_analysis of venice-real: " + "; ".join(
        f"level {r['level']} {r['kind']}: eliminated {r['eliminated']}, reduced "
        f"{r['reduced']}" + (f", {r['parts']} parts" if "parts" in r else "") for r in report))


def matrix_market_check(torch, asm, bs, timer):
    """(d): city10k's lambda from the card through save_matrix_market and
    back through scipy: equal to the card's blocks in float64."""
    import scipy.io as sio
    from slam_plus_plus_tpu_torch.linalg.bsr import block_system_to_scipy
    from slam_plus_plus_tpu_torch.utils.matrix_io import save_matrix_market

    path = os.path.join(_scene_dir(), "smoke_city10k_lambda.mtx")
    t0 = time.perf_counter()
    with timer.stage("mtx"):
        save_matrix_market(path, asm, bs)
    t_write = time.perf_counter() - t0
    read = sio.mmread(path, spmatrix=False).tocsr()   # a symmetric file reads back whole
    want = block_system_to_scipy(asm, bs)
    diff = abs(read - want).max()
    check(diff == 0.0 and want.dtype == np.float64, f"(d) MatrixMarket round trip: {diff}")
    print(f"(d) save_matrix_market of city10k's float64 lambda from the card: "
          f"{want.nnz} entries, {os.path.getsize(path) / 2**20:.1f} MiB written in "
          f"{t_write:.2f} s; read back by scipy equal to the card's blocks (max |diff| {diff})")
    os.remove(path)


def _scale_kappa(torch, co, r):
    """Each root's scale max(1, |r|) and condition number max(1, kappa),
    kappa = sum_k |c_k| |r|^(n-k) / (max(1, |r|) |p'(r)|) (at a near-double
    root p' -> 0, and a rounding difference of the two devices moves the
    root by up to ~sqrt(eps))."""
    r = torch.nan_to_num(r)
    n = co.shape[0] - 1
    p_abs = torch.zeros_like(r)
    dp = torch.zeros_like(r)
    for k in range(n + 1):
        p_abs = p_abs * r.abs() + co[k][:, None].abs()
        if k < n:
            dp = dp * r + co[k][:, None] * (n - k)
    scale = r.abs().clamp_min(1.0)
    return scale, (p_abs / (scale * dp.abs().clamp_min(1e-300))).clamp_min(1.0)


def _roots_agree(torch, name, co, got, want):
    """Card roots and counts against the CPU's: equal counts, equal NaN
    padding, and each root within POLY_TOL x max(1, |r|) x max(1, kappa)
    (_scale_kappa).  Returns (the largest error over its bound, the
    largest error x scale, kappa at that root, the count of roots with
    kappa > 1e3)."""
    (gr, gc), (wr, wc) = got, want
    gr, gc = gr.cpu(), gc.cpu()
    check(torch.equal(gc, wc), f"(e) {name}: root counts differ in "
          f"{int((gc != wc).sum())} of {len(wc)}")
    check(torch.equal(torch.isnan(gr), torch.isnan(wr)), f"(e) {name}: NaN padding differs")
    scale, kappa = _scale_kappa(torch, co, wr)
    ok = ~torch.isnan(wr)
    err = (gr - wr).abs() / scale
    ratio = float((err[ok] / (POLY_TOL * kappa[ok])).max())
    check(ratio <= 1.0, f"(e) {name}: a root {ratio:.3e} x its bound POLY_TOL x kappa from "
          f"the CPU's")
    worst = int(torch.argmax(torch.where(ok, err, 0.0).reshape(-1)))
    return (ratio, float(err.reshape(-1)[worst]), float(kappa.reshape(-1)[worst]),
            int((ok & (kappa > 1e3)).sum()))


def _raw_roots_agree(torch, name, co, got_raw, want_raw, want_p):
    """The closed forms themselves, before any polish: a raw root misses
    when it lies more than POLY_TOL x scale x kappa from the CPU's polished
    root.  The closed forms cancel badly on a few lanes on any device,
    each far past the bound, so the card's raw roots may miss in no more
    lanes than RAW_MISS_FACTOR x the CPU's raw roots do, plus
    RAW_MISS_SLACK.  A wrong cube root or power misses in most lanes of
    its branch.  Returns (card misses, CPU misses)."""
    scale, kappa = _scale_kappa(torch, co, want_p)
    ok = ~torch.isnan(want_p)
    bound = POLY_TOL * scale * kappa

    def misses(raw):
        return int((ok & ((raw - want_p).abs() > bound)).sum())
    n_card, n_cpu = misses(got_raw.cpu()), misses(want_raw)
    check(n_card <= RAW_MISS_FACTOR * n_cpu + RAW_MISS_SLACK,
          f"(e) {name}: {n_card} raw card roots miss POLY_TOL x scale x kappa of the CPU's "
          f"polished root, against {n_cpu} raw CPU roots")
    return n_card, n_cpu


def geometry_check(torch, dev, timer):
    """(e): the batched closed-form roots and the batched Kabsch average on
    the card against the same functions on the CPU, float64.  The closed
    forms (the JAX package's) cancel in Cardano's u + v as p -> 0 and in
    the quartic's resolvent steps, so a rounding difference moves a raw
    root far more than its conditioning says, on the CPU as on the card:
    the roots are compared after POLISH_ITERS Newton steps
    (polish_roots, as the reference polishes its closed forms), and the
    raw ones lane by lane against the polished roots, where the card may
    miss in no more lanes than the CPU does (_raw_roots_agree).  Leading
    coefficients are kept away from 0 (|a| >= 0.5), as the JAX test's
    cubics: with a ~1e-6 the closed forms lose the small roots on both
    devices."""
    from slam_plus_plus_tpu_torch.geometry import polynomial as P
    from slam_plus_plus_tpu_torch.geometry.struct_average import average_structure

    rng = np.random.default_rng(SEED)
    parts = []
    for name, fn, n_coef in (("quadratic", P.quadratic_roots, 3), ("cubic", P.cubic_roots, 4),
                             ("quartic", P.quartic_roots, 5)):
        co = torch.as_tensor(rng.normal(size=(n_coef, POLY_BATCH)))
        co[0] += torch.sign(co[0]) * 0.5
        if name == "quartic":       # a quarter from known real roots: four real roots
            q = POLY_BATCH // 4
            monic = torch.zeros((q, n_coef), dtype=torch.float64)
            monic[:, 0] = 1.0
            for root in torch.as_tensor(rng.normal(size=(n_coef - 1, q)) * 2):
                monic[:, 1:] = monic[:, 1:] - root[:, None] * monic[:, :-1]   # (x - root)
            co[:, :q] = monic.T
        cd = co.to(dev)
        with timer.stage("poly"):
            got = fn(*cd)
            got_p = P.polish_roots(cd.T, got[0], iters=POLISH_ITERS)
        ms = cuda_ms(torch, lambda: fn(*cd), reps=5, rounds=3)
        ms_p = cuda_ms(torch, lambda: P.polish_roots(cd.T, got[0], iters=POLISH_ITERS),
                       reps=5, rounds=3)
        want = fn(*co)
        want_p = P.polish_roots(co.T, want[0], iters=POLISH_ITERS)
        ratio, err, kappa, n_ill = _roots_agree(torch, name, co, (got_p, got[1]),
                                                (want_p, want[1]))
        n_miss, n_miss_cpu = _raw_roots_agree(torch, name, co, got[0], want[0], want_p)
        ok = ~torch.isnan(want[0])
        sc = want[0][ok].abs().clamp_min(1.0)
        raw = float(((got[0].cpu()[ok] - want[0][ok]).abs() / sc).max())
        moved = float(((want_p[ok] - want[0][ok]).abs() / sc).max())
        counts = torch.bincount(want[1].long(), minlength=n_coef).tolist()
        parts.append(f"{name} {ms:.3f} ms per batch (+ {ms_p:.3f} ms polish), counts {counts}, "
                     f"polished roots within {err:.2e} x scale (kappa {kappa:.2e} there), "
                     f"{n_ill} roots with kappa > 1e3, the largest error / bound {ratio:.2e}; "
                     f"raw roots within {raw:.2e} x scale of the CPU's, moved by the polish "
                     f"up to {moved:.2e}, {n_miss} raw card roots past the bound "
                     f"(CPU {n_miss_cpu})")
    print(f"(e) polynomial roots, {POLY_BATCH} equations per batch, card against CPU "
          f"(float64; equal counts, each polished root within {POLY_TOL:g} x scale x max(1, "
          f"its condition number)): " + "; ".join(parts))

    base = rng.normal(size=(STRUCT_POINTS, 3))
    a = rng.normal(size=(STRUCT_OBS, 3)) * 0.5
    th = np.linalg.norm(a, axis=1)[:, None, None]
    k = a / np.linalg.norm(a, axis=1)[:, None]
    K = np.zeros((STRUCT_OBS, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    obs = (np.einsum("oij,pj->opi", R, base) + rng.normal(size=(STRUCT_OBS, 1, 3)) * 5
           + rng.normal(0, 0.01, (STRUCT_OBS, STRUCT_POINTS, 3)))
    obs_t = torch.as_tensor(obs)
    od = obs_t.to(dev)
    with timer.stage("kabsch"):
        got = average_structure(od)
    ms = cuda_ms(torch, lambda: average_structure(od), reps=5, rounds=3)
    want = average_structure(obs_t)
    err = float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1.0)
    check(err <= STRUCT_TOL, f"(e) average_structure: {err:.3e} x scale > {STRUCT_TOL:g}")
    print(f"(e) average_structure of {STRUCT_OBS} observations of a {STRUCT_POINTS}-point "
          f"structure: {ms:.3f} ms on the card, {err:.3e} x scale from the CPU "
          f"(tol {STRUCT_TOL:g})")


def apps_check(torch, dev, timer):
    """(f): the ACRA study and the curve fit on the card against the CPU."""
    from slam_plus_plus_tpu_torch.app import ba_parameter_acra as acra
    from slam_plus_plus_tpu_torch.app import poly_fitting

    out = {}
    for d in (dev.type, "cpu"):
        t0 = time.perf_counter()
        with timer.stage(f"acra {d}"):
            out[d] = (acra.run_comparison(verbose=d == dev.type, device=d),
                      time.perf_counter() - t0)
    (rows, t_card), (ref, t_cpu) = out[dev.type], out["cpu"]
    check([r["param"] for r in rows] == ["xyz", "invdepth", "invdist"], "(f) acra rows")
    xyz, inv, dist = rows
    check(abs(xyz["chi2_init"] - inv["chi2_init"]) < 1e-6 * xyz["chi2_init"],
          "(f) acra: xyz and invdepth start apart")
    check(xyz["chi2_final"] < 0.05 * xyz["chi2_init"], f"(f) acra xyz: {xyz}")
    check(inv["chi2_final"] < 0.05 * inv["chi2_init"], f"(f) acra invdepth: {inv}")
    check(dist["chi2_final"] < 4.0 * xyz["chi2_final"], f"(f) acra invdist: {dist}")
    worst = 0.0
    for g, w in zip(rows, ref):
        check(g["iters"] == w["iters"], f"(f) acra {g['param']}: iterations {g} vs {w}")
        for key in ("chi2_init", "chi2_final"):
            worst = max(worst, abs(g[key] - w[key]) / abs(w[key]))
    check(worst <= ACRA_TOL, f"(f) acra rows {worst:.3e} relative from the CPU's")
    print(f"(f) run_comparison() (8 cameras, 120 points, {rows[0]['n_edges']} observations), "
          f"float64: card {t_card:.2f} s, CPU {t_cpu:.2f} s, rows within {worst:.3e} "
          f"relative (tol {ACRA_TOL:g}); gates of tests/test_sim3_grid.py met")

    true_c, xs, ys = poly_fitting.demo_data()
    with timer.stage("fit"):
        c, chi2 = poly_fitting.fit(xs, ys, device=dev.type)
    c_cpu, _ = poly_fitting.fit(xs, ys, device="cpu")
    truth = float(np.abs(c - true_c).max())
    err = float(np.abs(c - c_cpu).max())
    check(truth < 0.05 and err <= FIT_TOL, f"(f) fit: {truth:.3e} from the truth, {err:.3e} "
          f"from the CPU")
    print(f"(f) poly_fitting.fit (degree {len(c) - 1}, {len(xs)} samples) on the card: chi2 "
          f"{chi2:.6f}, coefficients {truth:.3e} from the truth (tol 0.05), {err:.3e} from "
          f"the CPU's (tol {FIT_TOL:g})")


def flops_check(asm, stage_split):
    """(g): analytic FLOP counts of the bench scene beside phase 4's stage
    times."""
    from slam_plus_plus_tpu_torch.utils.flops import assembly_flops, schur_flops

    fa, fs = assembly_flops(asm), schur_flops(asm)
    per_stage = {"assemble": fa["total"], "panels": fs["c_inv"] + fs["w"],
                 "sc_gemm": fs["sc_gemm"], "cholesky": fs["chol"], "update": fs["backsub"]}
    print("(g) bench scene FLOPs (utils/flops.py) over phase 4's median stage times: " +
          ", ".join(f"{k} {f:.4g} in {stage_split[k]:.3f} ms = "
                    f"{f / (stage_split[k] * 1e-3) / 1e9:.1f} GFLOP/s"
                    for k, f in per_stage.items()) +
          f"; Schur total {fs['total']:.4g}, assembly total {fa['total']:.4g}")


def tools_phase(torch, dev, card, kernels, stage_split):
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels
    from slam_plus_plus_tpu_torch.utils.timer import StageTimer

    print(f"phase 14 card: {card}")
    timer = StageTimer(device=dev)
    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    t0 = time.perf_counter()
    bench_asm = eigen_check(torch, dev, timer)
    city_asm, city_bs = condition_check(torch, dev, timer)
    nested_schur_check(dev, timer)
    matrix_market_check(torch, city_asm, city_bs, timer)
    del city_asm, city_bs
    geometry_check(torch, dev, timer)
    apps_check(torch, dev, timer)
    flops_check(bench_asm, stage_split)
    launches = (p2c_edge_terms.launches, build_panels.launches)
    check(launches[0] > 0, "phase 14: K1 was not launched")
    check(launches[1] == 0, f"phase 14: K2 launched {launches[1]} times")
    kernels[0]["launches_tools"] = launches[0]
    print(f"launches during phase 14: p2c_edge_terms {launches[0]}, build_panels "
          f"{launches[1]}")
    print(f"(g) StageTimer(device=cuda) over phase 14's parts "
          f"({time.perf_counter() - t0:.1f} s):\n" + timer.dump())


# ---- phase 15: parallel/ over torch.distributed ----------------------------

#: ranks of the gloo world; both share cuda:0 (NCCL refuses two ranks on one
#: card, so the NCCL run is a world of one)
DIST_RANKS = 2
#: damped steps held against the single-process card step, then timed steps
SHARDED_STEPS = 3
SHARDED_TIMED = 3
#: repetitions of each timed distributed factor / assembly
DIST_REPS = 3
#: the pose rows of (d), float64, and the bound on the relative residual of
#: their distributed solves.  The forward distance to the single-process
#: solve is printed, not gated: on the card the ranks' batched 3 x 3
#: products can round 1 ulp apart from the whole batch's when two ranks
#: share it, which these lambdas amplify to 1e-9..1e-7 (w100k's own
#: single-process factors differed by more while their sums were atomic;
#: PERF.md section 6)
DIST_CHOL_ROWS = ("city10k", "w100k")
DIST_CHOL_TOL = 1e-10
DIST_TIMEOUT_S = 300


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _synced(torch, dev, fn, reps):
    """(the last result, median host ms) of reps synchronized calls of fn."""
    times, out = [], None
    for _ in range(reps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def _shares(comm, reps, ms):
    """ms per call of each collective since the last read, and its share of
    a call of ms."""
    return {k: (v / reps, v / reps / ms) for k, v in comm.times_ms().items()}


def _sharded_rank(torch, dev, bench):
    """(a) / (b) on one rank: SHARDED_STEPS damped steps of ShardedBAOptimizer
    from the parsed states with the launch counters zeroed just before,
    then SHARDED_TIMED timed steps with each collective timed."""
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels
    from slam_plus_plus_tpu_torch.parallel import ShardedBAOptimizer

    t0 = time.perf_counter()
    opt = ShardedBAOptimizer(parse_g2o_fast(bench), device=dev)
    construct_s = time.perf_counter() - t0
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p2c_edge_terms.launches = 0
    build_panels.launches = 0
    cam, xyz = opt._cam_snapshot(), opt.xyz
    chis = []
    for _ in range(SHARDED_STEPS):
        cam, xyz, chi2 = opt.step(cam, xyz)
        chis.append(chi2)
    launches = [p2c_edge_terms.launches, build_panels.launches]
    arrays = dict(cam=cam["cam"].double().cpu().numpy(), xyz=xyz.double().cpu().numpy(),
                  locals=opt._l_locals)
    state = (opt._cam_snapshot(), opt.xyz)
    opt.step(*state)
    opt.comm.timing = True
    opt.comm.times_ms()
    _out, ms = _synced(torch, dev, lambda: opt.step(*state), SHARDED_TIMED)
    shares = _shares(opt.comm, SHARDED_TIMED, ms)
    opt.comm.timing = False
    return dict(chi2=[float(c) for c in chis], launches=launches, ms_step=ms, shares=shares,
                peak_gib=(torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda"
                          else float("nan")),
                per_device_bytes=opt.per_device_bytes(), G=opt.G, rows=int(opt.xyz.shape[0]),
                Nl=opt.asm.Nl, construct_s=construct_s), arrays


def _dist_schur_rank(torch, dev, bench):
    """(c) on one rank: DistributedAssembler (flat layout, edges sharded) and
    DistributedSchurSolver on the bench scene, float32."""
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.parallel import DistributedAssembler, DistributedSchurSolver
    from slam_plus_plus_tpu_torch.solvers.lm import damp_system

    system = parse_g2o_fast(bench)
    asm = DistributedAssembler(system, device=dev)
    sch = DistributedSchurSolver(asm)
    states = asm.snapshot_states(system)
    asm.comm.timing = sch.comm.timing = True
    asm.comm.times_ms()
    bs, ms_asm = _synced(torch, dev, lambda: asm.assemble(states), DIST_REPS)
    asm_shares = _shares(asm.comm, DIST_REPS, ms_asm)
    damped = damp_system(bs, bs.max_hdiag * 1e-3, asm.pp_diag_ids_dev)
    sch.comm.times_ms()
    (dx_p, dx_l), ms_solve = _synced(torch, dev, lambda: sch.solve(damped), DIST_REPS)
    solve_shares = _shares(sch.comm, DIST_REPS, ms_solve)
    arrays = {f: getattr(bs, f).double().cpu().numpy()
              for f in ("pp_blocks", "ll_blocks", "eta_p", "eta_l", "chi2", "max_hdiag")}
    arrays.update(dx_p=dx_p.double().cpu().numpy(), dx_l=dx_l.double().cpu().numpy())
    return dict(ms_assemble=ms_asm, assemble_shares=asm_shares, ms_solve=ms_solve,
                solve_shares=solve_shares, dtype=str(asm.dtype)[6:]), arrays


def _dist_chol_rank(torch, dev, paths):
    """(d) on one rank: DistributedBlockCholeskySolver on each row's float64
    lambda against the single-process factor of the same rank: the relative
    residual ||eta - lambda dx|| / ||eta|| of both solves (solve, and
    solve_with_factor on a second factor, which under deterministic
    algorithms must repeat it bit for bit), a second single-process solve
    (which must repeat the first bit for bit: the factor's sums run in a
    fixed order, ops/segsum.py), and the forward distance between the
    single-process and the distributed dx, under
    torch.use_deterministic_algorithms and with the default algorithms;
    then ms per factor of both, collectives timed."""
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
    from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv
    from slam_plus_plus_tpu_torch.parallel import DistributedBlockCholeskySolver

    out = {}
    for name, path in paths.items():
        system = parse_g2o_fast(path)
        asm = Assembler(system, device=dev, dtype=torch.float64)
        bs = asm.assemble(asm.snapshot_states(system))
        spmv = LambdaSpmv(asm)
        zl = torch.zeros((max(asm.Nl, 1), asm.Bl), dtype=torch.float64, device=dev)

        def residual(dx):
            r = bs.eta_p - spmv(bs, dx, zl)[0]
            return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bs.eta_p))

        single = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp, device=dev)
        distc = DistributedBlockCholeskySolver(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp,
                                               device=dev)
        res = {}
        for det in (True, False):
            torch.use_deterministic_algorithms(det)
            want = single.solve(bs.pp_blocks, bs.eta_p)
            again = single.solve(bs.pp_blocks, bs.eta_p)
            got = distc.solve(bs.pp_blocks, bs.eta_p)
            got_f = distc.solve_with_factor(distc.factor(bs.pp_blocks), bs.eta_p)
            res["deterministic" if det else "default"] = dict(
                residual_single=residual(want), residual_dist=residual(got),
                residual_dist_f=residual(got_f),
                forward=float((got - want).abs().max() / want.abs().max()),
                repeat=float((got_f - got).abs().max()),
                repeat_single=float((again - want).abs().max()))
        torch.use_deterministic_algorithms(False)
        _f, ms_single = _synced(torch, dev, lambda: single.factor(bs.pp_blocks), DIST_REPS)
        distc.comm.timing = True
        distc.comm.times_ms()
        _f, ms_dist = _synced(torch, dev, lambda: distc.factor(bs.pp_blocks), DIST_REPS)
        shares = _shares(distc.comm, DIST_REPS, ms_dist)
        distc.comm.timing = False
        out[name] = dict(res=res, levels=distc.n_levels, bottom=distc.plan.n_bottom,
                         dims=asm.Np * asm.Bp, ms_factor=ms_dist, ms_single=ms_single,
                         shares=shares)
    return out


def _dist_rank(rank, world, backend, store, out_dir, tasks, paths):
    """One spawned rank of phase 15 on cuda:0 (paths["device"]; "cpu" to
    rehearse): joins the group, runs tasks, writes its results to out_dir.
    Imports the port only (never JAX)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    from slam_plus_plus_tpu_torch.config import pin_precision
    from slam_plus_plus_tpu_torch.parallel import multihost

    pin_precision()
    dev = torch.device(paths["device"], 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    check(multihost.initialize(f"file://{store}", world, rank, backend=backend,
                               device=dev.type, timeout_s=DIST_TIMEOUT_S),
          "phase 15: no process group")
    out = dict(summary=multihost.process_summary())
    arrays = {}
    if "sharded" in tasks:
        out["sharded"], a = _sharded_rank(torch, dev, paths["bench"])
        arrays.update({f"sharded_{k}": v for k, v in a.items()})
    if "dist_schur" in tasks:
        out["dist_schur"], a = _dist_schur_rank(torch, dev, paths["bench"])
        arrays.update({f"dist_schur_{k}": v for k, v in a.items()})
    if "dist_chol" in tasks:
        out["dist_chol"] = _dist_chol_rank(torch, dev, {n: paths[n] for n in DIST_CHOL_ROWS})
    with open(os.path.join(out_dir, f"{backend}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    np.savez(os.path.join(out_dir, f"{backend}_rank{rank}.npz"), **arrays)
    dist.destroy_process_group()


def _spawn_world(world, backend, tasks, paths):
    """Run _dist_rank on world spawned ranks; a rank that fails fails the
    smoke (torch.multiprocessing ends the others and raises).  Returns each
    rank's (results, arrays)."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(_scene_dir(), f"dist_{backend}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    mp.start_processes(_dist_rank, args=(world, backend, store, out_dir, tasks, paths),
                       nprocs=world, join=True, start_method="spawn")
    res = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{backend}_rank{r}.json")) as f:
            res.append((json.load(f), dict(np.load(os.path.join(out_dir,
                                                                f"{backend}_rank{r}.npz")))))
    return res


def _fmt_shares(shares):
    return ", ".join(f"{k} {ms:.3f} ms ({sh:.1%})" for k, (ms, sh) in shares.items())


def _rel_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)


def _check_sharded(label, ranks, ref_chis, ref_states, card, dev):
    """(a) / (b): each rank's chi2 per step within 1e-5 relative of the
    single-process card step's, its cameras and the ranks' landmark rows
    together within 1e-4 x scale of its states, G rows per rank, K1 and K2
    launched on each rank (on the card: a CPU rehearsal runs the plain
    versions, which count nothing)."""
    G = -(-N_POINTS // len(ranks))
    for r, (res, arr) in enumerate(ranks):
        s = res["sharded"]
        chi_err = max(abs(a - b) / b for a, b in zip(s["chi2"], ref_chis))
        check(chi_err <= 1e-5, f"{label} rank {r}: chi2 {s['chi2']} against {ref_chis}")
        cam_err = _rel_err(arr["sharded_cam"], ref_states["cam"])
        check(cam_err <= 1e-4, f"{label} rank {r}: cameras {cam_err:.3e} x scale")
        check(s["G"] == G and s["rows"] == G, f"{label} rank {r}: {s['rows']} landmark rows, "
              f"not G = {G}")
        check(dev.type != "cuda" or all(n > 0 for n in s["launches"]),
              f"{label} rank {r}: launches {s['launches']}")
        coll = _fmt_shares(s["shares"])
        print(f"  {label} rank {r} ({res['summary']}): chi2 per step "
              + " / ".join(f"{c:.2f}" for c in s["chi2"]) +
              f", largest relative error {chi_err:.2e} (tol 1e-5), cameras {cam_err:.2e} x scale "
              f"(tol 1e-4); {s['ms_step']:.3f} ms per step (median of {SHARDED_TIMED}); "
              f"collectives per step {coll}; K1 {s['launches'][0]} and K2 {s['launches'][1]} "
              f"launches in {SHARDED_STEPS} steps; {s['rows']} landmark rows of {s['Nl']} (G = "
              f"{s['G']}); peak device memory {s['peak_gib']:.3f} GiB, per_device_bytes "
              f"{s['per_device_bytes']}; construct {s['construct_s']:.1f} s; on {card}")
    xyz = np.concatenate([arr["sharded_xyz"] for _res, arr in ranks])[:N_POINTS]
    xyz_err = _rel_err(xyz, ref_states["xyz"][ranks[0][1]["sharded_locals"]])
    check(xyz_err <= 1e-4, f"{label}: landmarks {xyz_err:.3e} x scale")
    print(f"  {label}: the ranks' landmark rows together within {xyz_err:.2e} x scale of the "
          f"single-process states (tol 1e-4)")


def parallel_phase(torch, dev, card, kernels, step, states0):
    """Phase 15: parallel/ over torch.distributed on cuda:0, each rank a
    spawned process."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.config import SolverSettings
    from slam_plus_plus_tpu_torch.io import datasets
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
    from slam_plus_plus_tpu_torch.parallel import multihost
    from slam_plus_plus_tpu_torch.solvers.lm import damp_system

    print(f"phase 15 card: {card}")
    bench = os.path.join(_scene_dir(), f"bench_ba_{N_CAMS}_{N_POINTS}_{SCENE_SEED}.txt")
    paths = dict(bench=bench, device=dev.type, **{n: pose_dataset(n) for n in DIST_CHOL_ROWS})
    # the single-process card step (phase 4's), SHARDED_STEPS times
    states, ref_chis = states0, []
    for _ in range(SHARDED_STEPS):
        states, chi2 = step(states)
        ref_chis.append(float(chi2))
    ref_states = {k: v.double().cpu().numpy() for k, v in states.items()}

    t0 = time.perf_counter()
    gloo = _spawn_world(DIST_RANKS, "gloo", ("sharded", "dist_schur", "dist_chol"), paths)
    t_gloo = time.perf_counter() - t0
    print(f"(a) ShardedBAOptimizer on the bench scene, {DIST_RANKS} gloo ranks on one card "
          f"(float32), against the single-process card step:")
    _check_sharded("(a) gloo", gloo, ref_chis, ref_states, card, dev)
    t0 = time.perf_counter()
    one = multihost.default_backend(dev)
    nccl = _spawn_world(1, one, ("sharded",), paths)
    t_nccl = time.perf_counter() - t0
    print(f"(b) the same at world size 1 over {one}:")
    _check_sharded(f"(b) {one}", nccl, ref_chis, ref_states, card, dev)
    for k, i in zip(kernels, range(2)):
        k["launches_sharded"] = {"gloo ranks": [r["sharded"]["launches"][i] for r, _a in gloo],
                                 "nccl": nccl[0][0]["sharded"]["launches"][i]}

    # (c) against the single-process card assembly of the same layout (flat:
    # the generic per-edge kernel), and, printed, the uniform K1 assembly
    fields = ("pp_blocks", "ll_blocks", "eta_p", "eta_l", "chi2", "max_hdiag")
    system = parse_g2o_fast(bench)
    refs = {}
    for layout in ("flat", "auto"):
        asm = Assembler(system, device=dev, settings=SolverSettings(edge_layout=layout))
        bs = asm.assemble(asm.snapshot_states(system))
        refs[layout] = {f: getattr(bs, f).double().cpu().numpy() for f in fields}
        if layout == "flat":
            dx = SchurSolver(asm).solve(damp_system(bs, bs.max_hdiag * 1e-3, asm.pp_diag_ids_dev))
            refs[layout].update(dx_p=dx[0].double().cpu().numpy(),
                                dx_l=dx[1].double().cpu().numpy())
        del asm, bs
    ref = refs["flat"]
    print(f"(c) DistributedAssembler + DistributedSchurSolver on the bench scene, {DIST_RANKS} "
          f"gloo ranks, against the single-process card assembly (flat layout, the same "
          f"per-edge kernel) and its damped step:")
    for r, (res, arr) in enumerate(gloo):
        c = res["dist_schur"]
        errs = {f: _rel_err(arr[f"dist_schur_{f}"], ref[f]) for f in fields}
        check(max(errs.values()) <= 1e-4, f"(c) rank {r}: block system {errs}")
        k1_err = max(_rel_err(arr[f"dist_schur_{f}"], refs["auto"][f]) for f in fields)
        dx_err = max(float(np.abs(arr[f"dist_schur_{k}"] - ref[k]).max())
                     / max(float(np.abs(ref[k]).max()), 1e-30) for k in ("dx_p", "dx_l"))
        check(dx_err <= 1e-2, f"(c) rank {r}: damped step {dx_err:.3e} relative")
        print(f"  (c) rank {r} ({c['dtype']}): block system max err/scale "
              f"{max(errs.values()):.3e} (tol 1e-4; against the uniform K1 assembly "
              f"{k1_err:.3e}, not gated), damped step {dx_err:.3e} relative (tol "
              f"1e-2); assemble {c['ms_assemble']:.2f} ms (collectives "
              f"{_fmt_shares(c['assemble_shares'])}), Schur solve {c['ms_solve']:.2f} ms (collectives "
              f"{_fmt_shares(c['solve_shares'])}); on {card}")

    print(f"(d) DistributedBlockCholeskySolver, float64, {DIST_RANKS} gloo ranks, against the "
          f"same rank's single-process factor (relative residual ||eta - lambda dx|| / ||eta|| "
          f"gated at {DIST_CHOL_TOL:g}; the forward distance printed):")
    for r, (res, _arr) in enumerate(gloo):
        for name, c in res["dist_chol"].items():
            for mode, e in c["res"].items():
                check(max(e["residual_dist"], e["residual_dist_f"]) <= DIST_CHOL_TOL
                      and (mode == "default" or e["repeat"] == 0.0)
                      and e["repeat_single"] == 0.0,
                      f"(d) rank {r} {name} {mode}: {e}")
            coll = _fmt_shares(c["shares"])
            det, ato = c["res"]["deterministic"], c["res"]["default"]
            print(f"  (d) rank {r} {name} ({c['dims']} dims, {c['levels']} MIS levels, bottom "
                  f"{c['bottom']} blocks): residual distributed {det['residual_dist']:.2e} / "
                  f"single {det['residual_single']:.2e} under deterministic algorithms, "
                  f"{ato['residual_dist']:.2e} / {ato['residual_single']:.2e} with the default "
                  f"ones (tol {DIST_CHOL_TOL:g}); two single-process solves bit for bit equal "
                  f"under both (the segmented sums); solve_with_factor on the replicated factor "
                  f"repeats the solve bit for bit under deterministic algorithms "
                  f"({ato['repeat']:.2e} apart with the default ones); forward distance to the "
                  f"single-process dx {det['forward']:.2e} (deterministic), "
                  f"{ato['forward']:.2e} (default); "
                  f"{c['ms_factor']:.2f} ms per distributed factor (single-process "
                  f"{c['ms_single']:.2f}), collectives {coll}; on {card}")

    # (e) the CLI's --dist-* on the card: two processes, NCCL (no collective)
    small = os.path.join(_scene_dir(), "smoke_dist_cli.g2o")
    datasets.write_g2o_ba(small, *datasets.make_ba_scene(n_cams=6, n_points=60, seed=3))
    store = os.path.join(_scene_dir(), "dist_cli_store")
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slam_plus_plus_tpu_torch.app.main", "-i", small, "--device",
         dev.type, "-dx", "", "-nb", "--dist-coord", f"file://{store}", "--dist-nprocs", "2",
         "--dist-procid", str(r)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    t_cli = time.perf_counter() - t0
    chi2, _iters, _s = cli.run(cli.build_argparser().parse_args(
        ["-i", small, "--device", dev.type, "-s", "-dx", "", "-nb"]))
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"process {r}/2, backend {one}" in out,
              f"(e) CLI process {r}: exit {p.returncode}\n{out[-2000:]}")
        summary = next(ln for ln in out.splitlines() if ln.startswith("process "))
        final = [ln for ln in out.splitlines() if ln.startswith("denormalized chi2")]
        print(f"  (e) CLI process {r}: exit 0, '{summary}', '{final[-1] if final else ''}' "
              f"(single-process {chi2:.2f})")
    print(f"phase 15 walls: gloo world {t_gloo:.1f} s, NCCL world {t_nccl:.1f} s, CLI pair "
          f"{t_cli:.1f} s")



# ---- phase 16: the entry points ----------------------------------------------

#: the entry points' time limits (the bench: set-up, 5 steps and the C++
#: extra, ~1 min; the acceptance rows: ~20 s)
ENTRY_TIMEOUT_S = 400
#: phase 10's rows that phase 16 replays once more, which must repeat to the bit
REPEAT_ROWS = ("intel-scale -nsp 1 -fL", "manhattan3500 -nsp 1 -fL")


def _entry_point(args, what):
    """Run ``python -m args`` from the repository's root; (exit code, the
    last line of its standard output, the output's tail)."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=ENTRY_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    tail = "\n".join(lines[-12:]) + "\n" + proc.stderr[-3000:]
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{tail}")
    check(bool(lines), f"{what} printed nothing")
    return proc.returncode, lines[-1], tail


def entry_points_phase(torch, dev, card, phase10):
    from slam_plus_plus_tpu_torch.app import acceptance as acc

    # (a) the bench entry point: the metric line, its gate and its launches
    t0 = time.perf_counter()
    _rc, last, _tail = _entry_point(["slam_plus_plus_tpu_torch.bench"], "the bench")
    out = json.loads(last)
    keys = ("metric", "value", "unit", "vs_baseline", "fastl_m3500_wall_s",
            "fastl_m3500_ms_per_applied_step", "fastl_m3500_chi2", "fastl_native")
    check(all(k in out for k in keys), f"the bench's line lacks {set(keys) - set(out)}")
    check(out["metric"] == "ba_solve_iter" and out["unit"] == "ms" and out["value"] > 0,
          f"the bench's line: {last}")
    check(out["chi2"] <= 1.05 * REF_FINAL_CHI2, f"the bench's chi2 {out['chi2']}")
    check(out["launches"]["p2c_edge_terms"] > 0 and out["launches"]["build_panels"] > 0,
          f"the bench's step launched {out['launches']}")
    check(out["fastl_native"] and out["fastl_m3500_chi2"] <= 1.05 * 1418.70,
          f"the bench's FastL extra: {out['fastl_m3500_chi2']}")
    print(f"(a) python -m slam_plus_plus_tpu_torch.bench: {out['value']} ms per damped Schur "
          f"step, vs_baseline {out['vs_baseline']}, chi2 {out['chi2']}; launches in its run "
          f"{out['launches']}; set-up {out['breakdown_s']}; FastL extra manhattan3500 -nsp 1 "
          f"-fL on the C++ engine: chi2 {out['fastl_m3500_chi2']}, wall "
          f"{out['fastl_m3500_wall_s']} s, {out['fastl_m3500_ms_per_applied_step']} ms per "
          f"applied step; {time.perf_counter() - t0:.1f} s with its process; on {card}")

    # (b) the acceptance runner on the intel-scale rows
    t0 = time.perf_counter()
    _rc, last, tail = _entry_point(["slam_plus_plus_tpu_torch.app.acceptance", "--rows",
                                    "intel-scale"], "the acceptance runner")
    summary = json.loads(last)
    check(summary["total"] == 2 and summary["passed"] == summary["total"],
          f"the acceptance runner: {summary}\n{tail}")
    rows = [json.loads(x) for x in tail.splitlines() if x.startswith('{"row"')]
    print(f"(b) python -m slam_plus_plus_tpu_torch.app.acceptance --rows intel-scale: " +
          "; ".join(f"{r['row']} chi2 {r['chi2']!r} (ratio {r['ratio']:.4f}), "
                    f"{r.get('ms_per_iteration', r.get('ms_per_solve_point')):.2f} ms per "
                    f"{'iteration' if 'ms_per_iteration' in r else 'solve point'}, wall "
                    f"{r['wall_s']:.1f} s" for r in rows) +
          f"; summary {summary}; {time.perf_counter() - t0:.1f} s with its process")

    # (c) the deterministic sums: phase 10's replays once more, to the bit
    for label in REPEAT_ROWS:
        row, _fl = acc.incremental_row(dev, card, label)
        check(row["chi2"] == phase10[label][0],
              f"{label}: chi2 {row['chi2']!r} against phase 10's {phase10[label][0]!r}")
        print(f"(c) {label} once more: chi2 {row['chi2']!r}, equal to phase 10's to the bit; "
              f"wall {row['wall_s']:.1f} s (phase 10: {phase10[label][2]:.1f} s)")


if __name__ == "__main__":
    sys.exit(main())
