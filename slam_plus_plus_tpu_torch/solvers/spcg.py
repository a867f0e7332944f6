"""Preconditioned conjugate-gradient solver ("SPCG").

Port of slam_plus_plus_tpu/solvers/spcg.py (reference
CNonlinearSolver_SPCG, include/slam/NonlinearSolver_SPCG.h:19,61): GN whose
linear solve is conjugate gradients over the normal equations, matrix-free
through the planar block SpMV, preconditioned by

  * "subgraph" (the default for pose graphs, the reference's design): a
    maximum-weight spanning tree of the pose graph (weight = information
    trace, Kruskal on the host), whose pattern restricts the full lambda
    (tree pairs + diagonal: a PSD shift of the tree's own SPD lambda) and
    is factored by the MIS-Schur block Cholesky.  A tree eliminates with
    zero fill and about half its vertices per level;
  * "jacobi": the inverted diagonal blocks (``planar.binv``), "auto"'s pick
    when a landmark class exists.

CG runs a fixed cg_iters trips, as the JAX package's ``lax.scan``: once
|r| <= cg_tol |b| a device-side mask freezes the iterate, so no trip reads
anything back to the host.  Each trip's tree solve is the block Cholesky's
chain of per-level launches.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver


def spanning_tree_pairs(system: GraphSystem, asm):
    """Kruskal's maximum-weight spanning forest over the binary edges
    (weight = information trace; ties keep insertion order): the kept
    (min, max) class-slot pairs, in the order Kruskal keeps them."""
    ws, cis, cjs = [], [], []
    for ename, store in system.edge_stores.items():
        if EDGE_TYPES[ename].arity != 2 or not store.n:
            continue
        ids = store.vertex_ids[:store.n]
        for col, out in ((0, cis), (1, cjs)):
            out.append(np.array([asm.type_cslot[system.vertex_directory[g][0]][
                system.vertex_directory[g][1]] for g in ids[:, col]], dtype=np.int64))
        ws.append(np.trace(store.informations[:store.n], axis1=1, axis2=2))
    if not ws:
        return []
    ci, cj = np.concatenate(cis), np.concatenate(cjs)
    order = np.argsort(-np.concatenate(ws), kind="stable")
    parent = np.arange(asm.Np)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    pairs = []
    for e in order.tolist():
        a, b = int(ci[e]), int(cj[e])
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        parent[ra] = rb
        pairs.append((min(a, b), max(a, b)))
    return pairs


class SPCGSolver(GaussNewtonSolver):
    """GN outer loop with a CG linear solver (no factorization of lambda)."""

    def __init__(self, system: GraphSystem, *, device,
                 settings: Optional[SolverSettings] = None,
                 cg_iters: int = 200, cg_tol: float = 1e-8, preconditioner: str = "auto"):
        # the assembler only: CG replaces GN's direct backends, so none is built
        t0 = time.perf_counter()
        self._setup(system, device, settings)
        self.cg_iters = cg_iters
        self.cg_tol = cg_tol
        asm = self.asm
        if preconditioner == "auto":
            preconditioner = "subgraph" if asm.Nl == 0 else "jacobi"
        if preconditioner not in ("subgraph", "jacobi"):
            raise ValueError(f"preconditioner {preconditioner!r}: auto, subgraph or jacobi")
        self.preconditioner = preconditioner
        self._spmv = LambdaSpmv(asm)
        if preconditioner == "subgraph":
            self._build_subgraph()
        self.timing["construct"] = time.perf_counter() - t0

    def _build_subgraph(self) -> None:
        """The tree pattern's positions in the full pp pattern and its block
        Cholesky plan (reference NonlinearSolver_SPCG.h:19 subgraph role).
        The preconditioner is the FULL lambda restricted to tree + diagonal
        pairs: one gather from the block system, no re-assembly."""
        asm = self.asm
        Np = asm.Np
        self.tree_pairs = spanning_tree_pairs(self.system, asm)
        keys_full = asm.pp_rows * Np + asm.pp_cols
        tp = np.array(sorted({r * Np + c for (r, c) in self.tree_pairs} |
                             {v * Np + v for v in range(Np)}), dtype=np.int64)
        self._tree_sel = torch.as_tensor(np.searchsorted(keys_full, tp), device=asm.device)
        self.tree_chol = BlockCholeskySolver(tp // Np, tp % Np, Np, asm.Bp, device=asm.device)

    def _preconditioner(self, bs):
        """The preconditioner's apply: (r_p, r_l) -> (z_p, z_l)."""
        asm = self.asm
        Bp, Bl = asm.Bp, asm.Bl
        if self.preconditioner == "subgraph":
            f = self.tree_chol.factor(bs.pp_blocks[self._tree_sel])
            return lambda r_p, r_l: (self.tree_chol.solve_with_factor(f, r_p), r_l)
        m_p = planar.binv(bs.pp_blocks[asm.pp_diag_ids_dev], Bp)
        m_l = planar.binv(bs.ll_blocks, Bl) if asm.Nl else None

        def apply(r_p, r_l):
            return (planar.bmv(m_p, r_p, Bp, Bp),
                    planar.bmv(m_l, r_l, Bl, Bl) if asm.Nl else r_l)
        return apply

    def _solve(self, bs):
        precond = self._preconditioner(bs)

        def dot(a_p, a_l, b_p, b_l):
            return torch.sum(a_p * b_p) + torch.sum(a_l * b_l)

        b_p, b_l = bs.eta_p, bs.eta_l
        x_p, x_l = torch.zeros_like(b_p), torch.zeros_like(b_l)
        r_p, r_l = b_p, b_l
        z_p, z_l = precond(r_p, r_l)
        p_p, p_l = z_p, z_l
        rz = dot(r_p, r_l, z_p, z_l)
        tol = self.cg_tol * torch.sqrt(dot(b_p, b_l, b_p, b_l))
        done = torch.zeros((), dtype=torch.bool, device=b_p.device)
        zero = torch.zeros((), dtype=b_p.dtype, device=b_p.device)
        for _ in range(self.cg_iters):
            Ap_p, Ap_l = self._spmv(bs, p_p, p_l)
            pAp = dot(p_p, p_l, Ap_p, Ap_l)
            alpha = torch.where(pAp > 0, rz / pAp, zero)
            x_p2, x_l2 = x_p + alpha * p_p, x_l + alpha * p_l
            r_p2, r_l2 = r_p - alpha * Ap_p, r_l - alpha * Ap_l
            z_p2, z_l2 = precond(r_p2, r_l2)
            rz2 = dot(r_p2, r_l2, z_p2, z_l2)
            beta = torch.where(rz > 0, rz2 / rz, zero)
            p_p2, p_l2 = z_p2 + beta * p_p, z_l2 + beta * p_l
            done2 = done | (torch.sqrt(dot(r_p2, r_l2, r_p2, r_l2)) <= tol)
            # freeze the iterate once converged (the JAX scan's update rule)
            keep = 1.0 - done.to(b_p.dtype)
            x_p, x_l = x_p + keep * (x_p2 - x_p), x_l + keep * (x_l2 - x_l)
            r_p, r_l = torch.where(done, r_p, r_p2), torch.where(done, r_l, r_l2)
            p_p, p_l = torch.where(done, p_p, p_p2), torch.where(done, p_l, p_l2)
            rz = torch.where(done, rz, rz2)
            done = done2
        return x_p, x_l
