"""Batch Gauss-Newton ("Lambda") solver.

Port of slam_plus_plus_tpu/solvers/gauss_newton.py (reference
CNonlinearSolver_Lambda::Optimize, include/slam/NonlinearSolver_Lambda.h:476-668):

    for iter in range(max_iters):
        refresh lambda at the current linearization point
        dx = solve(lambda, eta)
        if ||dx||_2 <= dx_threshold: break   # break BEFORE pushing
        x <- x ⊞ dx

The linear backend is chosen per structure, as in the JAX package
(its gauss_newton.py:59-77, with ``SolverSettings.linear_solver``):

  * the Schur complement whenever a landmark class is split off
    (linalg/schur.py: dense, or block-sparse with the block Cholesky for
    the reduced system on the sparse-reduced branch, venice-real's);
  * under "auto", a dense direct Cholesky for float64 systems of <= 6000
    scalar dims (never in float32: an unequilibrated pose-graph lambda has
    kappa ~1e8, beyond a single-precision direct factor);
  * the MIS-Schur sparse block Cholesky (linalg/block_cholesky.py) under
    "auto" and "block_cholesky", in float32 capped at 8 levels and wrapped
    as the preconditioner of a PCG with a fixed trip count and a
    solve-quality gate (``sparse_solve``);
  * the host splu oracle (linalg/host_solver.py) only under "scipy".

The dtype follows the route (``route_dtype``): the Schur route keeps
``default_dtype`` (float32 on the card), and the pose-graph route, the
block Cholesky, the dense factor or the scipy oracle with no landmark class
split off, runs ``float64_dtype``.  Float32 pose GN with the JAX package's
settings ended manhattan3500 at 1.13 x the reference's chi2 on the card
(lambda's soft modes fall below float32's rounding), float64 meets every
pose golden, and the pose rows are launch-bound (ROADMAP.md Queue 3).
``dtype=torch.float32`` keeps the float32 path: its PCG runs the JAX
package's refine_iterations (2) + 10 trips and stops at 1e-4 relative
residual, and its block Cholesky is capped at 8 levels.

Host syncs per GN iteration: one read of |dx| and chi2 together, plus, in
float32 on a block Cholesky (the pose-graph backend or the sparse-reduced
Schur's), one read of the bottom factor's status; "scipy" adds its one read
of lambda.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler, type_classes
from slam_plus_plus_tpu_torch.config import (SolverSettings, default_dtype, float64_dtype,
                                             pin_precision)
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.dense import DenseScatter, cholesky_solve
from slam_plus_plus_tpu_torch.linalg.host_solver import HostSparseSolver
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv

#: scalar dims up to which float64 systems take the dense direct factor
#: (the JAX package's value off the TPU)
DENSE_LIMIT = 6000
#: float32 depth cap of the block Cholesky: error through the elimination
#: grows with the level count (the JAX package saw O(1) error at 17 levels)
F32_MAX_LEVELS = 8
#: relative residual at which the float32 PCG stops (the JAX package's)
PCG_REL_TOL = 1e-4
#: PCG trip count in float32: the JAX package's refine_iterations (2) + 10
PCG_ITERATIONS = 12


def route_dtype(system: GraphSystem, device, settings: SolverSettings) -> torch.dtype:
    """The dtype of a GN / LM solve of system on device, decided from its
    vertex classes before any assembler is built: ``default_dtype`` on the
    Schur route (a landmark class split off and observed from the poses,
    any backend but "scipy": BA, Sim(3) BA), ``float64_dtype`` on the
    pose-graph route (pose graphs, landmark graphs past the split's 20000
    pose dims, ROCV, and every system under "scipy")."""
    classes = type_classes(system, settings)
    schur = settings.linear_solver != "scipy" and any(
        {classes[t] for t in store.etype.vertex_types} == {"p", "l"}
        for store in system.edge_stores.values() if store.n)
    return default_dtype(device) if schur else float64_dtype(device)


def sparse_solve(chol: BlockCholeskySolver, spmv: LambdaSpmv, bs, pcg_iters: int):
    """dx_p for the pose block system bs with the block Cholesky.

    pcg_iters > 0 wraps the factor as a PCG preconditioner (CG converges for
    any SPD preconditioner, where stationary refinement diverged once the
    float32 factor stopped being a contraction).  The loop runs pcg_iters
    times and freezes the iterate under a device-side mask once the
    residual reaches PCG_REL_TOL relative or rz stops being finite — the JAX package's while_loop with its early
    exit, without a sync per iteration.
    Then the gate: keep whichever of (direct, PCG) has the smaller true
    residual, and NaN the step if even that is >= |b| (the caller's loop
    stops on it).  Returns (dx_p, PCG iterations taken as a device scalar)."""
    f = chol.factor(bs.pp_blocks)
    b = bs.eta_p
    dx = chol.solve_with_factor(f, b)
    taken = torch.zeros((), dtype=torch.int64, device=b.device)
    if not pcg_iters:
        return dx, taken
    zl = torch.zeros((max(spmv.Nl, 1), spmv.Bl), dtype=b.dtype, device=b.device)

    def mv(x):
        return spmv(bs, x, zl)[0]

    def dot(a, c):
        return torch.sum(a * c)

    bn2 = dot(b, b)
    tol2 = PCG_REL_TOL * PCG_REL_TOL * bn2
    r_direct = b - mv(dx)
    x, r = dx, r_direct
    z = chol.solve_with_factor(f, r)
    p, rz = z, dot(r, z)
    active = torch.ones((), dtype=torch.bool, device=b.device)
    for _ in range(pcg_iters):
        active = active & (dot(r, r) > tol2) & torch.isfinite(rz)
        Ap = mv(p)
        alpha = rz / dot(p, Ap)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = chol.solve_with_factor(f, r_n)
        rz_n = dot(r_n, z_n)
        p_n = z_n + (rz_n / rz) * p
        x, r, z, p, rz = (torch.where(active, new, old) for new, old in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
        taken = taken + active.to(torch.int64)
    rel2 = dot(r, r) / torch.clamp_min(bn2, 1e-30)
    rel2_direct = dot(r_direct, r_direct) / torch.clamp_min(bn2, 1e-30)
    better = (rel2 < rel2_direct) & torch.isfinite(x).all()
    dx = torch.where(better, x, dx)
    rel2 = torch.minimum(rel2, rel2_direct)
    return torch.where(rel2 < 1.0, dx, torch.full_like(dx, float("nan"))), taken


class GaussNewtonSolver:
    def __init__(self, system: GraphSystem, *, device,
                 settings: Optional[SolverSettings] = None, dtype=None):
        """dtype: the assembler's (None: ``route_dtype``)."""
        t0 = time.perf_counter()
        self._setup(system, device, settings,
                    dtype or route_dtype(system, device, settings or SolverSettings()))
        asm = self.asm
        ls = self.settings.linear_solver
        use_schur = asm.Nl > 0 and asm.Kpl > 0 and ls != "scipy"
        self._schur = SchurSolver(asm) if use_schur else None

        f32 = asm.dtype == torch.float32
        self._dense = None
        if not use_schur and ls == "auto" and not f32 and asm.Np * asm.Bp <= DENSE_LIMIT:
            self._dense = DenseScatter(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp,
                                       asm.device)
        self._sparse_chol = None
        self._host = HostSparseSolver() if ls == "scipy" else None
        self.pcg_iterations = 0
        if not use_schur and self._dense is None and ls in ("auto", "block_cholesky"):
            # large pose graphs: the MIS-Schur block Cholesky (the
            # reference's CLinearSolver_UberBlock role)
            self._sparse_chol = BlockCholeskySolver(
                asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp, device=asm.device,
                **(dict(max_levels=F32_MAX_LEVELS) if f32 else {}))
            self._spmv = LambdaSpmv(asm)
            self.pcg_iterations = PCG_ITERATIONS if f32 else 0
        self.pcg_taken = []      # PCG iterations of each sparse solve (device scalars)
        self.timing["construct"] = time.perf_counter() - t0

    def _setup(self, system: GraphSystem, device, settings: Optional[SolverSettings],
               dtype=None):
        """What every solver of the GN family shares: the system, its
        settings and the assembler over it."""
        if not system.edge_stores:
            raise ValueError("cannot build a solver over an empty system "
                             "(no edges); add edges first")
        pin_precision()
        self.system = system
        self.settings = settings or SolverSettings()
        self.asm = Assembler(system, device=device, settings=self.settings, dtype=dtype)
        self.timing = {}

    def _solve(self, bs):
        """(dx_p [Np, Bp], dx_l [Nl, Bl]) for a (damped) BlockSystem."""
        asm = self.asm
        if self._schur is not None:
            return self._schur.solve(bs)
        zeros_l = torch.zeros((max(asm.Nl, 1), asm.Bl), dtype=bs.eta_p.dtype,
                              device=bs.eta_p.device)
        if self._dense is not None:
            dx = cholesky_solve(self._dense(bs.pp_blocks), bs.eta_p.reshape(-1))
            return dx.reshape(asm.Np, asm.Bp), zeros_l
        if self._sparse_chol is not None:
            dx, taken = sparse_solve(self._sparse_chol, self._spmv, bs, self.pcg_iterations)
            self.pcg_taken.append(taken)
            return dx, zeros_l
        if asm.Nl:
            return self._host.solve_partitioned(asm, bs)
        return self._host.solve_blocks(asm.pp_rows, asm.pp_cols, bs.pp_blocks, bs.eta_p,
                                       asm.Np, asm.Bp), zeros_l

    def optimize(self, max_iterations: int = 5, dx_threshold: float = 0.01,
                 verbose: bool = False):
        """Run GN; writes the optimized states back to the system.  The
        defaults are the reference's final-optimization settings.

        Returns (final_chi2, iterations_run).  ``self.iteration_log`` keeps
        (chi2 at the linearization point, |dx|) of every iteration."""
        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)
        self.iteration_log = []
        n_iters = 0
        for it in range(max_iterations):
            n_iters += 1
            bs = asm.assemble(states)
            dx_p, dx_l = self._solve(bs)
            dx_norm = torch.sqrt(torch.sum(dx_p * dx_p) + torch.sum(dx_l * dx_l))
            chi2, dx_norm = torch.stack([bs.chi2, dx_norm]).tolist()
            self.iteration_log.append((chi2, dx_norm))
            if verbose:
                print(f"iter {it}: chi2={chi2:.2f} |dx|={dx_norm:.6f}")
            if not math.isfinite(dx_norm):
                break  # Cholesky failure analogue: abort iteration
            if dx_norm <= dx_threshold:
                break  # reference: break before pushing (Lambda.h:648)
            states = asm.update(states, dx_p, dx_l)
        chi2 = float(asm.chi2(states))
        asm.writeback_states(self.system, states)
        self.timing["optimize"] = time.perf_counter() - t0
        return chi2, n_iters

    def chi2(self) -> float:
        states = self.asm.snapshot_states(self.system)
        return float(self.asm.chi2(states))


def optimize(system: GraphSystem, *, device, settings: Optional[SolverSettings] = None,
             max_iterations: int = 5, dx_threshold: float = 0.01, verbose: bool = False):
    solver = GaussNewtonSolver(system, device=device, settings=settings)
    return solver.optimize(max_iterations, dx_threshold, verbose=verbose)
