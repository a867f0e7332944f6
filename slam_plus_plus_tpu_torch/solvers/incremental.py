"""Incremental solver: per-edge replay with every-N scheduling.

Port of slam_plus_plus_tpu/solvers/incremental.py (reference
CNonlinearSolver_Lambda in incremental operation: CParseLoop::AppendSystem
-> Incremental_Step -> t_Incremental_Step, the loop-closure test and the
per-N-vertices schedule of include/slam/NonlinearSolver_Base.h:497-620 ->
Optimize(max_iters, thresh) with break-before-push on |dx| <= thresh,
include/slam/NonlinearSolver_Lambda.h:637-661).  The CLI's defaults are the
reference's: Optimize(10, 20) (src/slam_app/Main.cpp:704-705), and no final
batch optimization in incremental mode (include/slam_app/Main.h:1463-1467).

The FULL structure is laid out once and replayed with active-count masking
(Assembler.assemble_active): inactive edges carry zero information,
inactive vertices unit pivots, so the whole replay reuses one plan.  A newly
activated vertex is placed on the device from its introducing edge
(EdgeType.device_initializer), as the reference's parse-loop initializers
(include/slam/ParseLoop.h:138,399).

Graphs whose blocks are all <= 6 wide (pose graphs and landmark SLAM)
delegate to the maintained-factor engine, ``FastLSolver(...,
onetime_dx=False)``: between pushes the linearization is frozen, so lambda
maintained by omega updates equals the lambda solver's full
Refresh_Lambda.  Other graphs, ``SolverSettings(linear_solver="scipy")``
and a replay with a per-step callback (``on_step``, the CLI's -dsi dumps,
as the JAX CLI turns its fused path off for them) take this module's own
path: each iteration assembles the active prefix
and solves it by the Schur complement (a split landmark class), the dense
direct factor (<= DENSE_LIMIT scalar dims), the MIS-Schur block Cholesky,
or the host oracle, retrying a non-finite step with escalating damping.
Both run float64 on both devices (config.float64_dtype).
``native=True`` gives the delegate FastL the C++ engine (on the CPU;
solvers/native_engine.py); a replay that would take the own path raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
from slam_plus_plus_tpu_torch.config import SolverSettings, float64_dtype, pin_precision
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.dense import solve_dense_spd
from slam_plus_plus_tpu_torch.linalg.host_solver import HostSparseSolver
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
from slam_plus_plus_tpu_torch.models.types import VERTEX_TYPES
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver, replay_steps
from slam_plus_plus_tpu_torch.solvers.lm import damp_system
from slam_plus_plus_tpu_torch.solvers.native_engine import UnsupportedReplay

#: scalar dims up to which the own path takes the dense direct factor.  The
#: JAX package picks 20000 on a TPU and 6000 elsewhere; the port takes 6000
#: on both of its devices.
DENSE_LIMIT = 6000


def takes_fastl(system: GraphSystem, settings: SolverSettings) -> bool:
    """Whether the replay goes to the maintained-factor engine: every block
    at most 6 wide, and no host oracle asked for."""
    return settings.linear_solver != "scipy" and all(
        VERTEX_TYPES[t].tangent_dim <= 6 or st.n == 0
        for t, st in system.vertex_stores.items())


class IncrementalSolver:
    """Replays a fully parsed system edge by edge on one device.

    Usage:
        inc = IncrementalSolver(system, device="cuda", every_n=1)
        chi2, iters = inc.run()
    """

    def __init__(self, system: GraphSystem, *, device, every_n: int = 1,
                 max_iterations: int = 10, dx_threshold: float = 20.0,
                 settings: Optional[SolverSettings] = None, on_step=None,
                 native: bool = False):
        """The reference lambda solver's incremental policy: a solve only
        when a loop closure is pending at an every-N boundary,
        Optimize(max_iterations, dx_threshold).  on_step(solver, step
        index, states) runs after every step of run(); it takes the own
        path.  native: the delegate FastL runs the C++ engine."""
        if not system.edge_stores:
            raise ValueError("cannot replay an empty system (no edges)")
        t0 = time.perf_counter()
        pin_precision()
        self.system = system
        self.settings = settings or SolverSettings()
        self.every_n = every_n
        self.max_iterations = max_iterations
        self.dx_threshold = dx_threshold
        self.on_step = on_step

        dtype = float64_dtype(device)
        self._delegate = None
        delegates = every_n and on_step is None and takes_fastl(system, self.settings)
        if native and not delegates:
            raise UnsupportedReplay("the C++ engine serves the maintained-factor replay only: "
                                    "blocks at most 6 wide, no per-step callback, no host "
                                    "oracle")
        if delegates:
            self._delegate = FastLSolver(
                system, device=device, every_n=every_n, max_iterations=max_iterations,
                dx_threshold=dx_threshold, onetime_dx=False, native=native)
            self.asm = self._delegate.asm
            self.steps = self._delegate.steps
            self.timing = self._delegate.timing
            return
        self.asm = asm = Assembler(system, device=device, settings=dataclasses.replace(
            self.settings, edge_layout="flat"), dtype=dtype)
        ls = self.settings.linear_solver
        use_schur = asm.Nl > 0 and asm.Kpl > 0 and ls != "scipy"
        self._schur = SchurSolver(asm) if use_schur else None
        self._host = HostSparseSolver() if ls == "scipy" else None
        self._dense = (not use_schur and self._host is None and
                       asm.Np * asm.Bp <= DENSE_LIMIT)
        self._sparse_chol = None
        if not use_schur and self._host is None and not self._dense:
            self._sparse_chol = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, asm.Np,
                                                    asm.Bp, device=asm.device)
        self.steps = replay_steps(system)
        # class-wise active counts: vertices activate in insertion order, so
        # the p / l counts are prefix sums over that order
        p_flags = np.array([asm.type_class[system.vertex_directory[g][0]] == "p"
                            for g in system.vertex_order], dtype=np.int64)
        self._p_prefix = np.concatenate([[0], np.cumsum(p_flags)])
        self._l_prefix = np.concatenate([[0], np.cumsum(1 - p_flags)])
        self.timing = {"construct": time.perf_counter() - t0}

    # ------------------------------------------------------------------

    def _solve(self, bs):
        """(dx_p, dx_l) of an active-prefix block system."""
        asm = self.asm
        if self._schur is not None:
            return self._schur.solve(bs)
        zeros_l = torch.zeros((max(asm.Nl, 1), asm.Bl), dtype=bs.eta_p.dtype,
                              device=bs.eta_p.device)
        if self._dense:
            return solve_dense_spd(asm.pp_rows, asm.pp_cols, bs.pp_blocks, bs.eta_p,
                                   asm.Np, asm.Bp), zeros_l
        if self._sparse_chol is not None:
            return self._sparse_chol.solve(bs.pp_blocks, bs.eta_p), zeros_l
        if asm.Nl:
            return self._host.solve_partitioned(asm, bs)
        return self._host.solve_blocks(asm.pp_rows, asm.pp_cols, bs.pp_blocks, bs.eta_p,
                                       asm.Np, asm.Bp), zeros_l

    def _optimize(self, states, counts, nap, nal):
        """The reference's Optimize(): solve, break before pushing a small
        |dx|.  A non-finite plain step (a gauge-deficient incremental BA)
        is retried with escalating damping, the analogue of the
        reference's LM / dogleg fallback for BA problem types."""
        n_iters = 0
        for _ in range(self.max_iterations):
            n_iters += 1
            bs = self.asm.assemble_active(states, counts, nap, nal)
            dx_p, dx_l = self._solve(bs)
            norm = float(torch.sqrt(torch.sum(dx_p * dx_p) + torch.sum(dx_l * dx_l)))
            if not np.isfinite(norm):
                alpha = float(bs.max_hdiag) * 1e-6
                for _try in range(6):
                    dx_p, dx_l = self._solve(damp_system(bs, alpha, self.asm.pp_diag_ids_dev))
                    norm = float(torch.sqrt(torch.sum(dx_p * dx_p) + torch.sum(dx_l * dx_l)))
                    if np.isfinite(norm):
                        break
                    alpha *= 100.0
            if not np.isfinite(norm) or norm <= self.dx_threshold:
                break
            states = self.asm.update(states, dx_p, dx_l)
        return states, n_iters

    # ------------------------------------------------------------------

    def run(self, verbose: bool = False):
        """Replay every edge; returns (final chi2, total iterations)."""
        if self._delegate is not None:
            out = self._delegate.run(verbose=verbose)
            self.elapsed = self._delegate.elapsed
            self.n_solves = self._delegate.stats["solve_points"]
            return out
        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)
        last_optimized = 0
        had_closure = False
        total_iters = n_solves = 0
        counts = {n: 0 for n in asm.edge_data}
        for si, step in enumerate(self.steps):
            for (slot, _gid) in step["new_vs"]:
                states = asm.place_vertex(states, step["ename"], slot, step["li"])
            counts[step["ename"]] += 1
            had_closure = had_closure or step["closure"]
            n_active = step["n_active"]
            if self.every_n and n_active - last_optimized >= self.every_n:
                last_optimized = n_active
                if had_closure:
                    had_closure = False
                    nap, nal = int(self._p_prefix[n_active]), int(self._l_prefix[n_active])
                    states, it = self._optimize(states, counts, nap, nal)
                    total_iters += it
                    n_solves += 1
                    if verbose and n_solves % 200 == 0:
                        print(f"step {si}: solves={n_solves} iters={total_iters}")
            if self.on_step is not None:
                self.on_step(self, si, states)

        chi2 = float(asm.chi2_active(states, counts))
        asm.writeback_states(self.system, states)
        self.elapsed = self.timing["replay"] = time.perf_counter() - t0
        self.n_solves = n_solves
        if verbose:
            print(f"incremental done: {len(self.steps)} steps, {n_solves} solves, "
                  f"{total_iters} iterations, {self.elapsed:.2f}s")
        return chi2, total_iters
