"""Batch Gauss-Newton over the rectangular Jacobian A (the "A solver", -A).

Port of slam_plus_plus_tpu/solvers/a_solver.py (reference
CNonlinearSolver_A, include/slam/NonlinearSolver_A.h:314): the solver that
materializes the weighted block Jacobian A (one block row per edge,
chi2 = ||A dx - b||^2 after square-root-information weighting) plus the
unary gauge factor, and solves the least-squares system each iteration.
Like the reference it has no robust weighting, and it keeps the edges in
parse order (the flat layout).

The split is the JAX package's design: the weighted per-edge residuals and
Jacobians (b_e = -Lᵀr, A_e = LᵀJ with info = LLᵀ) come from the device, by
the generic forward-mode path of the assembler; the rectangular A, with
exact tangent dims and no padding, is built on the host and solved there by
scipy's LSQR.  This solver exists for verification, as in the reference, and
the A it builds is exposed for inspection (``materialize_A``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import edge_jacobians
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver


def weighted_terms(et, states, z, info):
    """(b_e [E, r], [A_e [E, r, tangent dim] per slot]) of a batch of edges:
    b_e = -Lᵀ r and A_e = Lᵀ J with info = L Lᵀ, J the Jacobian of the
    residual."""
    r = et.residual(states, z)
    Lt = torch.linalg.cholesky(info).mT
    return -(Lt @ r[..., None])[..., 0], [Lt @ J for J in edge_jacobians(et, states, z)]


class ASolver(GaussNewtonSolver):
    def __init__(self, system: GraphSystem, *, device,
                 settings: Optional[SolverSettings] = None):
        # the flat edge layout keeps A's block rows in parse order, like the
        # reference's A
        settings = dataclasses.replace(settings or SolverSettings(), edge_layout="flat")
        super().__init__(system, device=device, settings=settings)

    def _col_layout(self):
        """Scalar column offset per (class, cslot) with EXACT tangent dims
        (no padding — A's columns are the true unknowns)."""
        asm = self.asm
        offs_p, off = [], 0
        for (t, _li) in asm.p_order:
            offs_p.append(off)
            off += VERTEX_TYPES[t].tangent_dim
        offs_l = []
        for (t, _li) in asm.l_order:
            offs_l.append(off)
            off += VERTEX_TYPES[t].tangent_dim
        return offs_p, offs_l, off

    def materialize_A(self, states=None) -> Tuple[sp.csr_matrix, np.ndarray]:
        """(A, b): weighted block Jacobian + rhs at the current (or given)
        linearization point, including the unary gauge row block
        (reference CBasicUnaryFactorFactory's identity factor)."""
        asm = self.asm
        if states is None:
            states = asm.snapshot_states(self.system)
        offs_p, offs_l, n_cols = self._col_layout()
        offs_p, offs_l = np.asarray(offs_p, dtype=np.int64), np.asarray(offs_l, dtype=np.int64)
        rows, cols, vals, bs = [], [], [], []
        row_off = 0
        for plan in asm.plans:
            data = asm.edge_data[plan.name]
            et = EDGE_TYPES[plan.name]
            gathered = tuple(states[t].index_select(0, data["slot_local"][k])
                             for k, t in enumerate(et.vertex_types))
            wb, wjs = weighted_terms(et, gathered, data["z"], data["info"])
            m, E = et.residual_dim, plan.E
            bs.append(wb.detach().cpu().double().numpy().ravel())
            for k, t in enumerate(et.vertex_types):
                J = wjs[k].detach().cpu().double().numpy()        # [E, m, tdim]
                td = VERTEX_TYPES[t].tangent_dim
                cslot = np.asarray(plan.slot_cslot[k])
                col0 = offs_p[cslot] if plan.slot_class[k] == "p" else offs_l[cslot]
                r = (row_off + np.arange(E)[:, None, None] * m +
                     np.arange(m)[None, :, None])
                c = col0[:, None, None] + np.arange(td)[None, None, :]
                rows.append(np.broadcast_to(r, J.shape).ravel())
                cols.append(np.broadcast_to(c, J.shape).ravel())
                vals.append(J.ravel())
            row_off += E * m
        # unary gauge factor on the anchor vertex
        if asm.anchor_cslot is not None:
            t, _ = asm.p_order[asm.anchor_cslot]
            td = VERTEX_TYPES[t].tangent_dim
            c0 = offs_p[asm.anchor_cslot]
            rows.append(row_off + np.arange(td))
            cols.append(c0 + np.arange(td))
            vals.append(np.ones(td))
            bs.append(np.zeros(td))
            row_off += td
        A = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(row_off, n_cols)).tocsr()
        return A, np.concatenate(bs)

    def _solve_via_A(self, states):
        """One GN step through the rectangular system: min ||A dx - b||, by
        LSQR on the host.  Returns (dx_p, dx_l) on the device and |dx|."""
        asm = self.asm
        A, b = self.materialize_A(states)
        dx = spla.lsqr(A, b, atol=1e-12, btol=1e-12, iter_lim=8000)[0]
        offs_p, offs_l, _ = self._col_layout()
        dx_p = np.zeros((max(asm.Np, 1), asm.Bp))
        for s, (t, _li) in enumerate(asm.p_order):
            td = VERTEX_TYPES[t].tangent_dim
            dx_p[s, :td] = dx[offs_p[s]:offs_p[s] + td]
        dx_l = np.zeros((max(asm.Nl, 1), asm.Bl))
        for s, (t, _li) in enumerate(asm.l_order):
            td = VERTEX_TYPES[t].tangent_dim
            dx_l[s, :td] = dx[offs_l[s]:offs_l[s] + td]

        def dev(x):
            return torch.as_tensor(x, dtype=asm.dtype, device=asm.device)

        return dev(dx_p), dev(dx_l), float(np.sqrt(np.sum(dx_p ** 2) + np.sum(dx_l ** 2)))

    def optimize(self, max_iterations: int = 5, dx_threshold: float = 0.01,
                 verbose: bool = False):
        """CNonlinearSolver_A::Optimize semantics (the shared CSolverOps_Base
        schedule: refresh A, solve, threshold-break before push).  Returns
        (final chi2, iterations); ``self.iteration_log`` keeps |dx| of every
        iteration."""
        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)
        self.iteration_log = []
        n_iters = 0
        for it in range(max_iterations):
            n_iters += 1
            dx_p, dx_l, dx_norm = self._solve_via_A(states)
            self.iteration_log.append(dx_norm)
            if verbose:
                print(f"iter {it}: |dx|={dx_norm:.6f}")
            if not math.isfinite(dx_norm):
                break
            if dx_norm <= dx_threshold:
                break
            states = asm.update(states, dx_p, dx_l)
        chi2 = float(asm.chi2(states))
        asm.writeback_states(self.system, states)
        self.timing["optimize"] = time.perf_counter() - t0
        return chi2, n_iters
