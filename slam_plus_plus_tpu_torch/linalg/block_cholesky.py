"""Sparse block Cholesky by nested MIS-Schur elimination.

Port of slam_plus_plus_tpu/linalg/block_cholesky.py, which fills the role of
the reference's block Cholesky linear solver (CLinearSolver_UberBlock,
reference include/slam/LinearSolver_UberBlock.h:45,216,272):

  * each level eliminates a maximal independent set (MIS) of low-degree
    block vertices; by independence their pivot submatrix is block diagonal,
    so a level is one batched planar inverse plus batched block products
    and segmented sums in a fixed order (ops/segsum.py: the plan sorts each
    level's destinations once, so a factor repeats to the bit);
  * after the levels the reduced system is scattered dense and factored by
    one Cholesky;
  * the symbolic plan (per-level index arrays, host numpy, copied from the
    JAX package so the level arrays are equal) is built once per sparsity
    pattern and reused every iteration.

The elimination runs on the Jacobi-equilibrated system S lambda S with
S = diag(lambda)^-1/2.  The float32 aids of the JAX package are kept and
chosen by the dtype of the blocks, not by the device: a relative ridge on
each level's pivot blocks, and a ridge ladder on the dense bottom factor
(one host read of the factorization's status per factor).  The depth cap
(8 levels in float32) is the caller's ``max_levels``.

The factor's per-level artifacts also serve the recurrent marginal
covariance recovery (``marginals``: the Takahashi recurrence closes over
the fill pattern the plan already enumerates), and ``solve_with_factor``
takes several right-hand sides at once ([N, B, k]) for the Woodbury
updates of maintained marginals.

All block storage is planar [K, B*B] (see ops/planar.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.ops.segsum import SegmentSum


# ----------------------------------------------------------------------
# symbolic phase (host)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _Level:
    """Host index arrays for one elimination level (all numpy)."""
    n: int                    # vertices entering this level
    n_next: int               # vertices remaining after elimination
    n_elim: int
    K: int                    # pairs entering this level
    K_next: int               # pairs remaining (carry + fill)
    elim_orig: np.ndarray     # [nE] level ids of eliminated vertices
    rest_orig: np.ndarray     # [n_next] level ids of surviving vertices
    elim_diag_idx: np.ndarray  # [nE] pair index of (e,e) in this level
    u_src: np.ndarray         # [Ku] pair index of each coupling block
    u_flip: np.ndarray        # [Ku] bool: stored as (elim,rest) -> transpose
    u_elim: np.ndarray        # [Ku] compact elim id
    u_rest_next: np.ndarray   # [Ku] compact next-level id of the rest vertex
    pa: np.ndarray            # [T] index into W for fill products
    pb: np.ndarray            # [T] index into U for fill products
    p_flip: np.ndarray        # [T] bool: transpose product before scatter
    p_dst: np.ndarray         # [T] destination pair index in next level
    carry_src: np.ndarray     # [Kc] pair index in this level
    carry_dst: np.ndarray     # [Kc] pair index in next level


class SymbolicPlan:
    """MIS-Schur elimination plan for a fixed block sparsity pattern.

    Built once per pattern (reference: SymbolicDecomposition_Blocky,
    LinearSolver_UberBlock.h:272); `factor`/`solve` reuse it every call.
    """

    def __init__(self, rows: np.ndarray, cols: np.ndarray, N: int, B: int,
                 bottom: int = 512, max_degree: int = 16,
                 max_levels: int = 64, dense_cap: int = 32000):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if np.any(rows > cols):
            raise ValueError("pattern must be upper pairs (row <= col)")
        self.N, self.B = int(N), int(B)
        self.levels: List[_Level] = []

        # current level pattern: sorted unique keys r*n + c (r <= c) and the
        # mapping from original pair order (level 0 = caller's order)
        n = int(N)
        keys = rows * n + cols
        order = np.argsort(keys)
        keys = keys[order]
        if np.any(keys[1:] == keys[:-1]):
            raise ValueError("duplicate pairs in pattern")
        self.input_perm = order  # caller blocks -> level-0 storage order

        dense_cap_blocks = max(bottom, dense_cap // B)
        while n > bottom and len(self.levels) < max_levels:
            # stop when elimination stops paying: the remaining system is
            # dense-ish (fill) or progress is marginal — the dense MXU bottom
            # is cheaper than more scatter levels (the reference's own
            # dense-solver default for reduced systems).  On grid-like pose
            # graphs MIS clears ~90% of the vertices in 10-20 levels; the
            # remaining separator core is exactly the part that WANTS the
            # MXU as one dense factorization.
            density = len(keys) / (n * (n + 1) / 2)
            if density > 0.25 and n <= dense_cap_blocks:
                break
            lvl, keys, n_next = self._build_level(keys, n, max_degree)
            if lvl is None:
                break  # no progress possible (degree cap)
            self.levels.append(lvl)
            stalled = lvl.n_elim < max(16, 0.05 * n)
            n = n_next
            if stalled and n <= dense_cap_blocks:
                break
        if n * B > max(dense_cap, 40000):
            raise ValueError(
                f"elimination stalled with a {n * B}-dim reduced system; "
                f"graph too dense for the MIS-Schur engine (raise max_degree "
                f"or use the Schur/landmark path)")

        # level-0 row/col per (sorted) pair — for the Jacobi scaling of the
        # input blocks (and of incremental deltas)
        keys0 = np.sort(rows * N + cols)
        self.rows0 = (keys0 // N).astype(np.int64)
        self.cols0 = (keys0 % N).astype(np.int64)
        self.diag_pos0 = np.flatnonzero(self.rows0 == self.cols0)
        assert len(self.diag_pos0) == N, "every vertex needs a diagonal pair"

        # bottom: dense scatter plan for the remaining pattern
        self.n_bottom = n
        r = keys // n
        c = keys % n
        self._bottom_idx = planar.scatter_flat_indices(
            r, c, B, B, row_stride=n * B)
        off = r != c
        self._bottom_idx_t = planar.scatter_flat_indices(
            c, r, B, B, row_stride=n * B)
        self._bottom_off = off.astype(np.float64)
        self._tperm = [i * B + j for j in range(B) for i in range(B)]

    # -- host helpers ---------------------------------------------------

    @staticmethod
    def _build_level(keys: np.ndarray, n: int, max_degree: int):
        r = keys // n
        c = keys % n
        offd = r != c
        orr, occ = r[offd], c[offd]

        # adjacency (CSR) over off-diagonal pairs
        deg = np.bincount(orr, minlength=n) + np.bincount(occ, minlength=n)
        heads = np.concatenate([orr, occ])
        tails = np.concatenate([occ, orr])
        adj_order = np.argsort(heads, kind="stable")
        adj = tails[adj_order]
        adj_start = np.concatenate([[0], np.cumsum(np.bincount(heads,
                                                               minlength=n))])

        # greedy MIS by ascending degree.  The cap adapts to the current
        # degree distribution (fill raises degrees level by level — a fixed
        # cap stalls): eliminating the below-median-degree independent set
        # approximates minimum-degree fill behavior while keeping ~35-45%
        # of vertices per level in the batch.
        cap = max(max_degree, int(1.5 * np.median(deg)) + 1)
        elim_mask = np.zeros(n, dtype=bool)
        blocked = np.zeros(n, dtype=bool)
        for _ in range(8):
            vorder = np.argsort(deg, kind="stable")
            for v in vorder:
                if blocked[v] or deg[v] > cap:
                    continue
                elim_mask[v] = True
                blocked[v] = True
                blocked[adj[adj_start[v]:adj_start[v + 1]]] = True
            if elim_mask.any():
                break
            cap *= 2  # all degrees above cap: relax (guarantees progress)
        if not elim_mask.any():
            return None, keys, n

        elim_orig = np.flatnonzero(elim_mask)
        rest_orig = np.flatnonzero(~elim_mask)
        n_elim, n_next = len(elim_orig), len(rest_orig)
        rest_map = np.full(n, -1, dtype=np.int64)
        rest_map[rest_orig] = np.arange(n_next)
        elim_map = np.full(n, -1, dtype=np.int64)
        elim_map[elim_orig] = np.arange(n_elim)

        # diagonal pair index per eliminated vertex
        diag_keys = elim_orig * n + elim_orig
        elim_diag_idx = np.searchsorted(keys, diag_keys)
        assert np.array_equal(keys[elim_diag_idx], diag_keys), \
            "missing diagonal pair for eliminated vertex"

        # coupling (U) pairs: exactly one endpoint eliminated (both is
        # impossible by independence)
        er, ec = elim_mask[r], elim_mask[c]
        is_u = (er ^ ec) & offd
        u_src = np.flatnonzero(is_u)
        u_flip = er[u_src]  # stored (elim, rest): need B_{rest,elim} = ^T
        u_elim_v = np.where(u_flip, r[u_src], c[u_src])
        u_rest_v = np.where(u_flip, c[u_src], r[u_src])
        # group U by eliminated vertex for fill-pair generation
        gorder = np.argsort(u_elim_v, kind="stable")
        u_src = u_src[gorder]
        u_flip = u_flip[gorder]
        u_elim_v = u_elim_v[gorder]
        u_rest_v = u_rest_v[gorder]
        u_elim = elim_map[u_elim_v]
        u_rest_next = rest_map[u_rest_v]

        # carry pairs: both endpoints survive
        is_carry = ~er & ~ec
        carry_src = np.flatnonzero(is_carry)
        carry_keys = rest_map[r[carry_src]] * n_next + rest_map[c[carry_src]]

        # fill products: per eliminated vertex, all (i<=j) pairs of its
        # incident U blocks; vectorized by grouping on the (small, capped)
        # group size d
        counts = np.bincount(u_elim, minlength=n_elim)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pa_l, pb_l = [], []
        for d in np.unique(counts):
            if d == 0:
                continue
            gsel = np.flatnonzero(counts == d)
            ii, jj = np.triu_indices(d)
            base = starts[gsel][:, None]
            pa_l.append((base + ii[None, :]).ravel())
            pb_l.append((base + jj[None, :]).ravel())
        if pa_l:
            pa = np.concatenate(pa_l)
            pb = np.concatenate(pb_l)
        else:
            pa = np.zeros(0, dtype=np.int64)
            pb = np.zeros(0, dtype=np.int64)
        ra = u_rest_next[pa]
        rb = u_rest_next[pb]
        p_flip = ra > rb
        fill_keys = np.where(p_flip, rb * n_next + ra, ra * n_next + rb)

        next_keys = np.unique(np.concatenate([carry_keys, fill_keys]))
        carry_dst = np.searchsorted(next_keys, carry_keys)
        p_dst = np.searchsorted(next_keys, fill_keys)

        lvl = _Level(
            n=n, n_next=n_next, n_elim=n_elim, K=len(keys),
            K_next=len(next_keys),
            elim_orig=elim_orig, rest_orig=rest_orig,
            elim_diag_idx=elim_diag_idx,
            u_src=u_src, u_flip=u_flip, u_elim=u_elim,
            u_rest_next=u_rest_next,
            pa=pa, pb=pb, p_flip=p_flip, p_dst=p_dst,
            carry_src=carry_src, carry_dst=carry_dst)
        return lvl, next_keys, n_next


# ----------------------------------------------------------------------
# numeric phase (device)
# ----------------------------------------------------------------------

class BlockCholeskyFactor(NamedTuple):
    """Factorization artifacts: per-level (c_inv, W) + the dense bottom
    factor of the equilibrated system (its own diagonal scale beside it)
    and the level-0 Jacobi scaling."""
    c_invs: Tuple[torch.Tensor, ...]  # [nE_k, B*B] each
    Ws: Tuple[torch.Tensor, ...]      # [Ku_k, B*B] each
    L_bottom: torch.Tensor            # [nb*B, nb*B] lower Cholesky (scaled)
    scale: torch.Tensor               # [nb*B] bottom equilibration diag
    s_vert: torch.Tensor              # [N, B] level-0 Jacobi scaling


#: float32 bottom ridges, tried in order until the factor is finite
RIDGE_LADDER = (1e-5, 1e-3, 1e-1, 10.0)


def _equilibrated_cholesky(dense):
    """(L, s): Cholesky of the diagonally scaled bottom.  float64 factors it
    once (a failed factor gives NaN, as XLA's does).  float32: a deep
    elimination can push bottom diagonal entries negative under round-off,
    so it scales by |d| and takes the smallest ridge of RIDGE_LADDER that
    gives a finite factor; the caller's PCG corrects against the true
    residual, so a ridge only weakens the preconditioner."""
    d = torch.diagonal(dense)
    if dense.dtype != torch.float32:
        s = torch.rsqrt(torch.clamp_min(d, 1e-10))
        L, info = torch.linalg.cholesky_ex(dense * s[:, None] * s[None, :])
        return L.masked_fill(info != 0, float("nan")), s
    s = torch.rsqrt(torch.clamp_min(torch.abs(d), 1e-10))
    A = dense * s[:, None] * s[None, :]
    for ridge in RIDGE_LADDER:
        L, info = torch.linalg.cholesky_ex(A + ridge * torch.eye(
            A.shape[0], dtype=A.dtype, device=A.device))
        if bool((info == 0) & torch.isfinite(L).all()):
            break
    else:
        L = torch.full_like(A, float("nan"))
    return L, s


def _bottom_solve(L, s, rhs):
    """rhs [nb, k] -> [nb, k] through the equilibrated bottom factor."""
    y = torch.linalg.solve_triangular(L, rhs * s[:, None], upper=False)
    return s[:, None] * torch.linalg.solve_triangular(L.mT, y, upper=True)


def _bmm_t(W, x):
    """Per-block W^T x: W [K, B*B] planar, x [K, B, k] -> [K, B, k] (as a
    [K, k, B] product, which is ``planar.bmv_At``'s for k = 1)."""
    K, B = x.shape[0], x.shape[1]
    return torch.bmm(x.transpose(1, 2), W.reshape(K, B, B)).transpose(1, 2)


class _DeviceLevel(NamedTuple):
    """One level's index arrays as tensors on the solver's device, and its
    segmented sums (fill products into the next level, couplings into the
    eliminated and the surviving vertices, the marginals' Sigma_ER and
    Sigma_EE terms)."""
    n: int
    n_next: int
    n_elim: int
    K: int
    K_next: int
    has_fill: bool
    elim_orig: torch.Tensor
    rest_orig: torch.Tensor
    elim_diag_idx: torch.Tensor
    u_src: torch.Tensor
    u_flip: torch.Tensor
    u_elim: torch.Tensor
    u_rest_next: torch.Tensor
    pa: torch.Tensor
    pb: torch.Tensor
    p_flip: torch.Tensor
    p_dst: torch.Tensor
    carry_src: torch.Tensor
    carry_dst: torch.Tensor
    fill_sum: SegmentSum
    elim_sum: SegmentSum
    rest_sum: SegmentSum
    er_sum: SegmentSum
    ee_sum: SegmentSum


def _device_level(lv: _Level, t, device) -> _DeviceLevel:
    Ku = len(lv.u_src)
    return _DeviceLevel(
        lv.n, lv.n_next, lv.n_elim, lv.K, lv.K_next, bool(len(lv.pa)),
        t(lv.elim_orig), t(lv.rest_orig), t(lv.elim_diag_idx), t(lv.u_src),
        t(lv.u_flip), t(lv.u_elim), t(lv.u_rest_next), t(lv.pa), t(lv.pb),
        t(lv.p_flip), t(lv.p_dst), t(lv.carry_src), t(lv.carry_dst),
        SegmentSum(lv.p_dst, lv.K_next, device),
        SegmentSum(lv.u_elim, lv.n_elim, device),
        SegmentSum(lv.u_rest_next, lv.n_next, device),
        SegmentSum(np.concatenate([lv.pb, lv.pa]), Ku, device),
        SegmentSum(np.concatenate([np.arange(lv.n_elim), lv.u_elim]), lv.n_elim, device))


class BlockCholeskySolver:
    """Sparse block SPD solver with a cached symbolic plan, on one device.

    Usage:
        solver = BlockCholeskySolver(rows, cols, N, B, device=dev)
        dx = solver.solve(blocks_planar, eta)          # factor + solve
        f = solver.factor(blocks_planar)               # reuse across rhs
        dx = solver.solve_with_factor(f, eta)
    """

    def __init__(self, rows, cols, N: int, B: int, *, device, bottom: int = 512,
                 max_degree: int = 16, dense_cap: int = 32000,
                 max_levels: int = 64):
        self.plan = SymbolicPlan(rows, cols, N, B, bottom=bottom,
                                 max_degree=max_degree, dense_cap=dense_cap,
                                 max_levels=max_levels)
        self.N, self.B = int(N), int(B)
        self.device = torch.device(device)
        plan = self.plan

        def t(x):
            return torch.as_tensor(np.asarray(x), device=self.device)

        self._levels = [_device_level(lv, t, self.device) for lv in plan.levels]
        self._input_perm = t(plan.input_perm)
        self._diag_pos0 = t(plan.diag_pos0)
        self._rows0, self._cols0 = t(plan.rows0), t(plan.cols0)
        self._bottom_idx = t(plan._bottom_idx.reshape(-1))
        self._bottom_idx_t = t(plan._bottom_idx_t.reshape(-1))
        self._bottom_off = t(plan._bottom_off)
        self._tperm = t(plan._tperm)

    # -- numeric kernels -------------------------------------------------

    def _jacobi_scale(self, H):
        """s_vert [N, B] = diag(H)^-1/2 and the per-pair planar scale array
        (outer product of the pair's row/col scales)."""
        B = self.B
        d = planar.bdiag(H[self._diag_pos0], B)
        s = torch.rsqrt(torch.clamp_min(d, 1e-30))
        sr, sc = s[self._rows0], s[self._cols0]
        return s, (sr[:, :, None] * sc[:, None, :]).reshape(H.shape[0], B * B)

    def _descend(self, H, trace=None):
        """Run the elimination levels: (bottom blocks, c_invs, Ws).  trace:
        a list that gets each level's (entering blocks, fill products)."""
        B = self.B
        c_invs, Ws = [], []
        f32 = H.dtype == torch.float32
        for lv in self._levels:
            C = H[lv.elim_diag_idx]
            if f32:
                # depth guard: a pivot block drifting near-singular under
                # round-off makes the inverse explode; a relative ridge
                # bounds its condition (the PCG corrects the solve)
                dmean = torch.mean(torch.abs(planar.bdiag(C, B)), dim=1)
                C = planar.badd_diag(C, 1e-5 * torch.clamp_min(dmean, 1e-30), B)
            c_inv = planar.binv(C, B)
            U0 = H[lv.u_src]
            U = torch.where(lv.u_flip[:, None], planar.btranspose(U0, B, B), U0)
            W = planar.bmm(U, c_inv[lv.u_elim], B, B, B)
            Hn = torch.zeros((lv.K_next, B * B), dtype=H.dtype, device=H.device)
            Hn[lv.carry_dst] = H[lv.carry_src]
            prod = None
            if lv.has_fill:
                prod = planar.bmm_A_Bt(W[lv.pa], U[lv.pb], B, B, B)
                prod = torch.where(lv.p_flip[:, None], planar.btranspose(prod, B, B), prod)
                Hn = Hn - lv.fill_sum(prod)
            if trace is not None:
                trace.append((H, prod))
            H = Hn
            c_invs.append(c_inv)
            Ws.append(W)
        return H, c_invs, Ws

    def _bottom_dense(self, H):
        nb = self.plan.n_bottom * self.B
        dense = torch.zeros(nb * nb, dtype=H.dtype, device=H.device)
        # each call writes every position once (a diagonal block's mirror
        # adds zeros): a scatter in a fixed order
        dense.index_add_(0, self._bottom_idx, H.reshape(-1))
        mirrored = H[:, self._tperm] * self._bottom_off.to(H.dtype)[:, None]
        dense.index_add_(0, self._bottom_idx_t, mirrored.reshape(-1))
        return dense.reshape(nb, nb)

    def _ascend(self, x_bottom, c_invs, Ws, etas):
        """Back-substitute up through the levels ([n, B, k] columns)."""
        B = self.B
        x = x_bottom  # [n_bottom, B, k]
        k = x.shape[2]
        for li in range(len(self._levels) - 1, -1, -1):
            lv = self._levels[li]
            # x_e = C^-1 eta_e - sum_u W_u^T x_rest(u)
            corr = _bmm_t(Ws[li], x[lv.u_rest_next])
            x_e = torch.bmm(c_invs[li].reshape(-1, B, B), etas[li]) - lv.elim_sum(corr)
            xk = torch.zeros((lv.n, B, k), dtype=x.dtype, device=x.device)
            xk[lv.rest_orig] = x
            xk[lv.elim_orig] = x_e
            x = xk
        return x

    # -- public ----------------------------------------------------------

    def factor(self, blocks) -> BlockCholeskyFactor:
        """Factor planar blocks [K, B*B] given in the caller's pair order."""
        H = blocks[self._input_perm]
        sv, outer = self._jacobi_scale(H)
        Hb, c_invs, Ws = self._descend(H * outer)
        L, s = _equilibrated_cholesky(self._bottom_dense(Hb))
        return BlockCholeskyFactor(tuple(c_invs), tuple(Ws), L, s, sv)

    def solve_with_factor(self, f: BlockCholeskyFactor, eta):
        """eta [N, B] -> dx [N, B], or k right-hand sides at once: eta
        [N, B, k] -> dx [N, B, k] in one descent and one ascent."""
        B = self.B
        cols = eta.dim() == 3
        eta = (eta if cols else eta[:, :, None]) * f.s_vert[:, :, None]
        k = eta.shape[2]
        etas = []
        for lv, W in zip(self._levels, f.Ws):
            eta_E = eta[lv.elim_orig]
            etas.append(eta_E)
            corr = torch.bmm(W.reshape(-1, B, B), eta_E[lv.u_elim])
            eta = eta[lv.rest_orig] - lv.rest_sum(corr)
        nb = self.plan.n_bottom * B
        xb = _bottom_solve(f.L_bottom, f.scale, eta.reshape(nb, k))
        dx = self._ascend(xb.reshape(self.plan.n_bottom, B, k), f.c_invs, f.Ws, etas)
        dx = dx * f.s_vert[:, :, None]
        return dx if cols else dx[:, :, 0]

    def solve(self, blocks, eta):
        """Factor + solve: blocks [K, B*B] planar (caller's pair order),
        eta [N, B].  Returns dx [N, B].

        This is the JAX package's one-pass ``_factor_solve_impl`` (which the
        sparse-reduced Schur calls): ``factor`` then ``solve_with_factor``
        run the same operations in the same order, the rhs descending the
        levels after the blocks instead of beside them, so no separate
        one-pass routine is kept."""
        return self.solve_with_factor(self.factor(blocks), eta)

    # -- recurrent sparse marginals ---------------------------------------

    def marginals(self, f: BlockCholeskyFactor):
        """Sigma = lambda^-1 on the level-0 pattern, in PLAN order, from a
        factor: the JAX module's Takahashi-style backward recurrence over
        the levels (reference: the ICRA-2015 recurrent formula,
        include/slam/Marginals.h:1694,2694), never a dense n x n matrix:

          Sigma_bot   = dense inverse of the bottom factor
          Sigma_ER[u] = -sum_i W_i^T Sigma_{rho_i, rho_u}   (fill-pair plan)
          Sigma_EE[e] = C_e^-1 - sum_u Sigma_ER[u] W_u
          Sigma_RR    = carry copy from the level below

        Every Sigma_{rho_i, rho_j} it needs lies on the next level's
        pattern (fill closure).  The bottom's equilibration and the level-0
        Jacobi scaling are undone on the way."""
        B = self.B
        BB = B * B
        nb = self.plan.n_bottom * B
        L = f.L_bottom
        dt, dev = L.dtype, L.device
        Linv = torch.linalg.solve_triangular(
            L, torch.eye(nb, dtype=dt, device=dev), upper=False)
        # undo the bottom equilibration: Sigma = S (S A S)^-1 S
        sig_dense = (Linv.mT @ Linv) * f.scale[:, None] * f.scale[None, :]
        Sig = sig_dense.reshape(-1)[self._bottom_idx].reshape(-1, BB)
        for li in range(len(self._levels) - 1, -1, -1):
            lv = self._levels[li]
            W = f.Ws[li]
            Ku = lv.u_src.shape[0]
            Sig_ER = torch.zeros((Ku, BB), dtype=dt, device=dev)
            if lv.has_fill:
                G = Sig[lv.p_dst]                        # stored blocks
                Gt = planar.btranspose(G, B, B)
                flip = lv.p_flip[:, None]
                S_ab = torch.where(flip, Gt, G)          # Sigma_{rho_a, rho_b}
                S_ba = torch.where(flip, G, Gt)
                term_b = planar.bmm_At_B(W[lv.pa], S_ab, B, B, B)
                term_a = planar.bmm_At_B(W[lv.pb], S_ba, B, B, B)
                term_a = term_a * (lv.pa != lv.pb).to(dt)[:, None]
                Sig_ER = -lv.er_sum(torch.cat([term_b, term_a]))
            # Sigma_EE = C^-1 - sum_u Sigma_ER[u] W_u, summed from C^-1 on
            Sig_EE = lv.ee_sum(torch.cat([f.c_invs[li], -planar.bmm(Sig_ER, W, B, B, B)]))
            Sig_k = torch.zeros((lv.K, BB), dtype=dt, device=dev)
            Sig_k[lv.carry_src] = Sig[lv.carry_dst]
            Sig_k[lv.elim_diag_idx] = Sig_EE
            # a pair stored as (e, rho) holds Sigma_ER, one stored (rho, e)
            # its transpose
            Sig_k[lv.u_src] = torch.where(lv.u_flip[:, None], Sig_ER,
                                          planar.btranspose(Sig_ER, B, B))
            Sig = Sig_k
        # undo the level-0 Jacobi scaling: Sigma = S Sigma' S
        sr, sc = f.s_vert[self._rows0], f.s_vert[self._cols0]
        return Sig * (sr[:, :, None] * sc[:, None, :]).reshape(-1, BB)

    def marginals_from_stores(self, stores, inc):
        """Marginals from the incremental engine's maintained flat stores
        (inc: the IncrementalCholesky that owns their layout)."""
        return self.marginals(inc.to_factor(stores))

    @property
    def n_levels(self) -> int:
        return len(self.plan.levels)
