"""Distributed pose-graph factorization: the MIS-Schur levels over a process
group (port of slam_plus_plus_tpu/parallel/dist_cholesky.py).

Reference role: the sparse block Cholesky products of
CLinearSolver_UberBlock / the Schur products (reference
include/slam/LinearSolver_Schur.h:1744-1767), single-node there; here each
level's batched work of linalg/block_cholesky.py is split over the ranks:

  * H (the pattern blocks) and the pivot inverses stay replicated: at B = 3
    a w100k-class level 0 is ~35 MB, and the pivot inverse is one cheap
    batched pass;
  * the coupling products W = U C⁻¹ are computed on a 1/n slice of the U
    axis per rank and all-gathered (every rank's fill products need
    arbitrary W rows);
  * the fill products, each level's dominant work, run on a 1/n slice of
    the product axis per rank; the partial ``index_add_`` into the next
    level's pattern is completed by one ``all_reduce``.  The slices are cut
    at destination boundaries (about T / n products each): every
    next-level block is summed on one rank, in the single-process order,
    and the other ranks add exact zeros to it.  Where ``index_add_`` is
    deterministic (the CPU) the factor is then the single-process one bit
    for bit; a cut across a destination (the JAX module's even split, pad
    lanes into a dropped segment) sums in another order, and on a pose
    graph's lambda (kappa ~1e8 and more) that moves the solve by up to
    ~1e-10 relative;
  * the dense bottom factor and the triangular solves run replicated.

Per level the collectives move one W all-gather ([Ku, B*B]) and one next-H
sum ([K_next, B*B]).  The factor comes back replicated, so
``solve_with_factor`` and the recurrent marginals run on it unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.linalg.block_cholesky import (
    BlockCholeskyFactor, BlockCholeskySolver, _equilibrated_cholesky)
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.parallel.collectives import Collectives


class DistributedBlockCholeskySolver(BlockCholeskySolver):
    """BlockCholeskySolver whose elimination levels split the W and fill
    product work over the group's ranks; the factor is replicated and the
    solves are the base class's."""

    def __init__(self, rows, cols, N: int, B: int, *, device, group=None, **kw):
        super().__init__(rows, cols, N, B, device=device, **kw)
        self.comm = Collectives(group)
        n, r = self.n_shards, self.rank = self.comm.size, self.comm.rank

        def t(x):
            return torch.as_tensor(x, device=self.device)

        self._shards = []
        for lv in self.plan.levels:
            # this rank's lanes of the U axis, padded to a multiple of n (pad
            # lanes read block 0 and are masked)
            Ku = len(lv.u_src)
            per = -(-max(Ku, 1) // n)
            lanes = np.arange(r * per, (r + 1) * per)
            u_idx, u_mask = t(np.where(lanes < Ku, lanes, 0)), t(lanes < Ku)[:, None]
            # this rank's products: those whose destination lies in its cut
            # of the destinations, in their order
            dst = np.sort(lv.p_dst)
            cuts = dst[np.arange(1, n) * len(dst) // n] if len(dst) else []
            bounds = np.concatenate([[0], cuts, [lv.K_next]]).astype(np.int64)
            sel = np.flatnonzero((lv.p_dst >= bounds[r]) & (lv.p_dst < bounds[r + 1]))
            self._shards.append(dict(u_idx=u_idx, u_mask=u_mask, pa=t(lv.pa[sel]),
                                     pb=t(lv.pb[sel]), p_flip=t(lv.p_flip[sel]),
                                     p_dst=t(lv.p_dst[sel])))

    def factor(self, blocks) -> BlockCholeskyFactor:
        """Factor planar blocks [K, B*B] (the caller's pair order, the same
        on every rank); the factor is replicated."""
        B = self.B
        H = blocks[self._input_perm]
        sv, outer = self._jacobi_scale(H)
        H = H * outer
        c_invs, Ws = [], []
        for lv, sh in zip(self._levels, self._shards):
            C = H[lv.elim_diag_idx]
            if H.dtype == torch.float32:
                # the single-process float32 pivot ridge (block_cholesky.py)
                dmean = torch.mean(torch.abs(planar.bdiag(C, B)), dim=1)
                C = planar.badd_diag(C, 1e-5 * torch.clamp_min(dmean, 1e-30), B)
            c_inv = planar.binv(C, B)                                   # replicated
            U0 = H[lv.u_src]
            U = torch.where(lv.u_flip[:, None], planar.btranspose(U0, B, B), U0)
            W = U
            if U.shape[0]:
                ui = sh["u_idx"]
                W_loc = planar.bmm(U[ui], c_inv[lv.u_elim[ui]], B, B, B) * sh["u_mask"]
                W = self.comm.gather("W", W_loc)[:U.shape[0]]
            Hn = torch.zeros((lv.K_next, B * B), dtype=H.dtype, device=H.device)
            Hn[lv.carry_dst] = H[lv.carry_src]
            if lv.has_fill:
                prod = planar.bmm_A_Bt(W[sh["pa"]], U[sh["pb"]], B, B, B)
                prod = torch.where(sh["p_flip"][:, None], planar.btranspose(prod, B, B), prod)
                part = torch.zeros((lv.K_next, B * B), dtype=H.dtype, device=H.device)
                part.index_add_(0, sh["p_dst"], prod)
                (fill,) = self.comm.sum("fill", part)
                Hn = Hn - fill
            H = Hn
            c_invs.append(c_inv)
            Ws.append(W)
        L, s = _equilibrated_cholesky(self._bottom_dense(H))
        return BlockCholeskyFactor(tuple(c_invs), tuple(Ws), L, s, sv)
