"""Marginal covariance recovery.

Port of slam_plus_plus_tpu/marginals/covariance.py (reference CMarginals,
include/slam/Marginals.h:70-5224, the ICRA-2015 fast covariance recovery,
and CSchurComplement_Marginals, include/slam/BAMarginals.h:388, the
3DV-2017 Schur-domain BA marginals).  Sigma = lambda^-1 is recovered
through the structures the solvers already build:

  * a pose-only system up to SPARSE_POSE_DIMS dims: the dense inverse of
    lambda (one Cholesky, triangular solves against the identity);
  * a larger pose-only system: the recurrent recovery over the MIS-Schur
    block Cholesky factor (``BlockCholeskySolver.marginals``), O(fill), no
    dense n x n matrix;
  * a system with a landmark class: Sigma_pp = SC^-1 of the reduced camera
    system, and per landmark Sigma_l = C_l^-1 + W_l^T Sigma_pp W_l with
    W = U C^-1 (the reference's CUTTSolve_Bases_Impl, BAMarginals.h:238).
    SC and W come from the Schur solver's own route: the uniform panels
    (kernel K2 on the card), the flat branch's landmark chunks (one GEMM
    Sigma_pp @ W_panel per chunk), or, past SPARSE_SCHUR_DIMS reduced dims
    or on request, the block-sparse SC and the recurrent recovery over its
    factor (every Sigma_pp block the landmark correction needs lies on the
    SC fill pattern).

Marginals are taken of the undamped lambda, as the reference refreshes
lambda with null damping first (NonlinearSolver_Lambda_LM.h:1138-1142);
``gauge_jitter`` adds a relative ridge for gauge-deficient systems (mono
BA's scale freedom leaves SC singular).  Like the reference, lambda keeps
its unit anchor block, which makes it invertible.

``IncrementalMarginals`` keeps the block diagonal up to date by Woodbury
updates through the cached factor (reference
Update_BlockDiagonalMarginals_FBS_ExOmega, Marginals.h:5224).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import edge_linearization
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.dense import DenseScatter
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.solvers.lm import damp_system

#: pose-only dims past which mode "auto" takes the recurrent recovery
SPARSE_POSE_DIMS = 1500
#: reduced dims past which a landmark system's SC is formed block-sparsely
SPARSE_SCHUR_DIMS = 20000
MODES = ("auto", "sparse", "sparse_schur")
#: Woodbury columns an IncrementalMarginals takes before it asks for a
#: recompute (the reference's b_CanUpdate() policy)
MAX_UPDATE_RANK = 64
#: observation pairs per slice of the sparse-Schur landmark correction (its
#: gathered [pairs, Bp*Bp] blocks stay near 1 GiB in float64)
PAIR_CHUNK = 1 << 22


class MarginalsResult(NamedTuple):
    p_diag: torch.Tensor   # [Np, Bp*Bp] planar block diagonal of Sigma_pp
    l_diag: torch.Tensor   # [max(Nl, 1), Bl*Bl] planar (zeros without landmarks)


def _cholesky(A):
    """Lower Cholesky factor; NaN where the factorization fails (no host
    sync), as ``linalg.dense.cholesky_solve``."""
    L, info = torch.linalg.cholesky_ex(A)
    return L.masked_fill(info != 0, float("nan"))


def _spd_inverse(A):
    """A^-1 through its Cholesky factor: L^-T L^-1."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    inv_l = torch.linalg.solve_triangular(_cholesky(A), eye, upper=False)
    return inv_l.mT @ inv_l


class Marginals:
    """Block-diagonal covariance recovery bound to an Assembler's structure
    and device.

    mode: "auto" inverts a pose-only system densely up to SPARSE_POSE_DIMS
    dims and takes the recurrent recovery past them, and forms a landmark
    system's SC densely up to SPARSE_SCHUR_DIMS reduced dims and
    block-sparsely past them; "sparse" forces the recurrent recovery of a
    pose-only system, "sparse_schur" the block-sparse SC of a landmark
    system.  ``route`` names the route taken:
    dense, sparse, schur_uniform, schur_flat or sparse_schur.
    """

    def __init__(self, asm, gauge_jitter: float = 0.0, mode: str = "auto"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {', '.join(MODES)}")
        self.asm = asm
        self.gauge_jitter = gauge_jitter
        Np, Bp = asm.Np, asm.Bp
        nred = Np * Bp

        def t(x):
            return torch.as_tensor(np.asarray(x), device=asm.device)

        def inverse_perm(perm):
            inv = np.empty(len(perm), dtype=np.int64)
            inv[perm] = np.arange(len(perm))
            return inv

        self.schur_mode = asm.Nl > 0 and asm.Kpl > 0
        if self.schur_mode and (nred > SPARSE_SCHUR_DIMS or mode == "sparse_schur"):
            self.route = "sparse_schur"
            sch = self._schur = SchurSolver(
                asm, sparse_reduced_limit=min(SPARSE_SCHUR_DIMS, max(nred - 1, 1)))
            assert sch.sparse_reduced
            inv = inverse_perm(sch.reduced_chol.plan.input_perm)
            diag_keys = np.arange(Np) * Np + np.arange(Np)
            self._sc_diag_plan = t(inv[np.searchsorted(sch.sc_keys, diag_keys)])
            self._fill_dst_plan = t(inv[sch.fill_dst])
            self._lm_seg = t(asm.pl_cols[sch.fill_pa])
            self._pair_offd = t(sch.fill_pa != sch.fill_pb)
        elif self.schur_mode:
            self._schur = SchurSolver(asm, dense_reduced=True)
            self.route = "schur_uniform" if self._schur.uniform else "schur_flat"
        elif mode == "sparse" or (mode == "auto" and nred > SPARSE_POSE_DIMS):
            self.route = "sparse"
            self._sparse = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, Np, Bp,
                                               device=asm.device)
            self._inv_perm = t(inverse_perm(self._sparse.plan.input_perm))
            self._diag_pos = self._inv_perm[t(asm.pp_diag_ids)]
        else:
            self.route = "dense"
            self._dense_pp = DenseScatter(asm.pp_rows, asm.pp_cols, Np, Bp, asm.device)

    def _p_diag(self, sigma):
        """[Np, Bp*Bp] diagonal blocks of a dense [Np*Bp, Np*Bp] Sigma."""
        Np, Bp = self.asm.Np, self.asm.Bp
        return sigma.reshape(Np, Bp, Np, Bp).diagonal(dim1=0, dim2=2).permute(2, 0, 1).reshape(
            Np, Bp * Bp)

    def _no_landmarks(self, like):
        asm = self.asm
        return like.new_zeros((max(asm.Nl, 1), asm.Bl * asm.Bl))

    def compute(self, bs) -> MarginalsResult:
        """The block diagonals of Sigma for a BlockSystem of this assembler."""
        asm = self.asm
        if self.gauge_jitter:
            bs = damp_system(bs, bs.max_hdiag * self.gauge_jitter, asm.pp_diag_ids_dev)
        Bp, Nl, Bl = asm.Bp, asm.Nl, asm.Bl
        nred = asm.Np * Bp
        if self.route == "sparse":
            sig = self._sparse.marginals(self._sparse.factor(bs.pp_blocks))
            return MarginalsResult(sig[self._diag_pos], self._no_landmarks(sig))
        if self.route == "dense":
            sigma = _spd_inverse(self._dense_pp(bs.pp_blocks))
            return MarginalsResult(self._p_diag(sigma), self._no_landmarks(sigma))

        sch = self._schur
        if self.route == "sparse_schur":
            c_inv, u, w, _rhs = sch._sparse_w_rhs(bs)
            rc = sch.reduced_chol
            Sig = rc.marginals(rc.factor(sch._sparse_sc(bs, u, w)))   # PLAN order
            # Sigma_l = C^-1 + sum over observation pairs w_a^T Sigma_ab w_b
            l_diag = c_inv.clone()
            for lo in range(0, len(sch.fill_pa), PAIR_CHUNK):
                sl = slice(lo, lo + PAIR_CHUNK)
                Sg = Sig[self._fill_dst_plan[sl]]
                Sg = torch.where(sch._fill_flip[sl, None], planar.btranspose(Sg, Bp, Bp), Sg)
                t1 = planar.bmm_At_B(w[sch._fill_pa[sl]], Sg, Bl, Bp, Bp)
                t2 = planar.bmm(t1, w[sch._fill_pb[sl]], Bl, Bp, Bl)
                t2 = t2 + planar.btranspose(t2, Bl, Bl) * self._pair_offd[sl, None].to(t2.dtype)
                l_diag.index_add_(0, self._lm_seg[sl], t2)
            return MarginalsResult(Sig[self._sc_diag_plan], l_diag)

        if self.route == "schur_uniform":
            c_inv, Ut, Wt = sch._uniform_panels(bs)
            sc, _rhs = sch._reduce(bs, Ut, Wt)
            sigma_pp = _spd_inverse(sc)
            # Sigma_l = C^-1 + W_l^T SC^-1 W_l per landmark, from the row
            # partitioned W panel
            P = Wt @ sigma_pp                                       # [Nl*Bl, nred]
            corr = torch.bmm(Wt.reshape(Nl, Bl, nred), P.reshape(Nl, Bl, nred).mT)
            return MarginalsResult(self._p_diag(sigma_pp), c_inv + corr.reshape(Nl, Bl * Bl))

        # the flat branch: SC over the landmark chunks, then per chunk
        # P = Sigma_pp @ W_panel and Sigma_l = C_l^-1 + W_l^T P_l
        c_inv, _u, w, sc, _rhs = sch._flat_reduce(bs)
        sigma_pp = _spd_inverse(sc)
        w_sorted = w[sch._order]
        l_diag = c_inv.clone()
        C = sch.chunk
        for ci, lo, hi in sch._flat_chunks():
            wp = sch._flat_panel(w_sorted, lo, hi)
            P = sigma_pp @ wp
            corr = torch.einsum("rci,rcj->cij", wp.reshape(nred, C, Bl), P.reshape(nred, C, Bl))
            first = ci * C
            n = min(C, Nl - first)
            l_diag[first:first + n] += corr[:n].reshape(n, Bl * Bl)
        return MarginalsResult(self._p_diag(sigma_pp), l_diag)


    def sigma_blocks(self, bs):
        """Sigma on lambda's pattern, [Kpp, Bp*Bp] planar in the
        assembler's pair order, by the recurrent recovery (route "sparse"
        only, as in the JAX package; no gauge jitter).  The off-diagonal
        blocks feed the compact-pose distance tests (reference
        include/slam/Distances.h:79)."""
        if self.route != "sparse":
            raise ValueError("sigma_blocks requires mode='sparse'")
        sig = self._sparse.marginals(self._sparse.factor(bs.pp_blocks))
        return sig[self._inv_perm]


class IncrementalMarginals:
    """Incrementally updated block-diagonal covariance of a pose-only system.

    After new edges add omega = G G^T to lambda, the cached diagonal updates
    by Woodbury (reference Update_BlockDiagonalMarginals_FBS_ExOmega,
    Marginals.h:5224):

        Sigma' = Sigma - X (I + G^T X)^-1 X^T,     X = Sigma G

    with X solved through the cached factor (all k columns in one solve) and
    the earlier corrections replayed, O(n k) per update instead of a fresh
    factorization; past MAX_UPDATE_RANK columns in all, ``update`` refuses
    (the b_CanUpdate() policy) and the caller recomputes.  A system with a
    landmark class takes recomputes only.
    """

    def __init__(self, asm):
        self.asm = asm
        self._L = None             # dense Cholesky factor of lambda_pp
        self._factor = None        # MIS-Schur factor (route "sparse")
        self._sigma_diag = None    # [Np, Bp*Bp]
        # Sigma_now = Sigma_0 - sum_i X_i K_i X_i^T: repeated updates solve
        # against the cached factor and replay these
        self._corrections = []
        self._rank_used = 0
        self._marg = Marginals(asm)

    def compute(self, bs) -> MarginalsResult:
        """Full recompute; caches the factor for the updates after it."""
        res = self._marg.compute(bs)
        self._corrections = []
        self._rank_used = 0
        self._L = self._factor = None
        if self._marg.route == "sparse":
            self._factor = self._marg._sparse.factor(bs.pp_blocks)
        elif self._marg.route == "dense":
            self._L = _cholesky(self._marg._dense_pp(bs.pp_blocks))
        self._sigma_diag = res.p_diag
        return res

    def b_can_update(self, k: int) -> bool:
        return ((self._L is not None or self._factor is not None)
                and self._rank_used + k <= MAX_UPDATE_RANK)

    def _sigma_mul(self, G):
        """Sigma_now @ G [n, k] through the cached factor and the replayed
        corrections."""
        if self._L is not None:
            Y = torch.linalg.solve_triangular(self._L, G, upper=False)
            X = torch.linalg.solve_triangular(self._L.mT, Y, upper=True)
        else:
            asm = self.asm
            X = self._marg._sparse.solve_with_factor(
                self._factor, G.reshape(asm.Np, asm.Bp, -1)).reshape(G.shape)
        for Xi, Ki in self._corrections:
            X = X - Xi @ (Ki @ (Xi.mT @ G))
        return X

    def update(self, G):
        """Rank-k update after lambda grew by G G^T (G [n, k]: square-root
        columns of the new edges' omega).  Repeatable until the total rank
        passes MAX_UPDATE_RANK; then raises ValueError (recompute)."""
        k = G.shape[1]
        if not self.b_can_update(k):
            raise ValueError("update not possible; recompute required")
        asm = self.asm
        X = self._sigma_mul(G)
        K = torch.linalg.inv(torch.eye(k, dtype=G.dtype, device=G.device) + G.mT @ X)
        Xb = X.reshape(asm.Np, asm.Bp, k)
        corr = (Xb @ K) @ Xb.mT
        self._sigma_diag = self._sigma_diag - corr.reshape(asm.Np, asm.Bp * asm.Bp)
        self._corrections.append((X, K))
        self._rank_used += k
        return self._sigma_diag

    @staticmethod
    def omega_sqrt_for_edge(asm, states, ename: str, eidx: int):
        """omega_sqrt_for_edges of one edge: G [Np*Bp, m]."""
        return IncrementalMarginals.omega_sqrt_for_edges(asm, states, ename, [eidx])

    @staticmethod
    def omega_sqrt_for_edges(asm, states, ename: str, eidxs):
        """G columns [Np*Bp, m*E] of a batch of E edges of one type, G G^T
        their omega: each edge's Jacobians weighted by the square root of
        its information, both as the assembler linearizes the edge
        (``edge_linearization``), placed at its vertices' class slots; edge
        e's columns are m*e .. m*(e+1).  (The JAX package differentiates
        the residual and skips the robust weight, which for a split type
        such as edge_pose3d is not the omega FastL adds to lambda: ROADMAP.md
        Queue 3.)"""
        et = EDGE_TYPES[ename]
        data = asm.edge_data[ename]
        eidx = torch.as_tensor(np.atleast_1d(np.asarray(eidxs, dtype=np.int64)),
                               device=asm.device)
        E, m, Bp = eidx.shape[0], et.residual_dim, asm.Bp
        gathered = tuple(states[t].index_select(0, data["slot_local"][k][eidx])
                         for k, t in enumerate(et.vertex_types))
        _r, jacs, info = edge_linearization(et, gathered, data["z"][eidx], data["info"][eidx])
        w, V = torch.linalg.eigh(info)
        sqrt_w = (V * torch.sqrt(torch.clamp_min(w, 0.0))[:, None, :]) @ V.mT
        G = torch.zeros((asm.Np * Bp, E * m), dtype=info.dtype, device=info.device)
        # edge e's column block m*e.. and, per slot, its vertex's rows
        col = (torch.arange(E, device=info.device)[:, None, None] * m +
               torch.arange(m, device=info.device)[None, None, :])
        for k, J in enumerate(jacs):
            d = J.shape[-1]
            row = (data["slot_cslot"][k][eidx][:, None, None] * Bp +
                   torch.arange(d, device=info.device)[None, :, None])
            G.index_put_((row.expand(E, d, m).reshape(-1), col.expand(E, d, m).reshape(-1)),
                         (sqrt_w @ J).mT.reshape(-1), accumulate=True)
        return G
