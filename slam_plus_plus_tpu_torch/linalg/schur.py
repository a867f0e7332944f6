"""Schur-complement elimination of the landmark class, dense reduced system.

Port of slam_plus_plus_tpu/linalg/schur.py::SchurSolver's dense branches
(reference CLinearSolver_Schur::Solve_PosDef_Blocky,
include/slam/LinearSolver_Schur.h:1623-1849, with its dense reduced solve).

The uniform per-landmark layout of mono BA (kernel K2 builds the panels):

    c_inv   = planar.binv(ll)                             [Nl, Bl*Bl]
    Ut, Wt  = build_panels(...)   (kernel K2)             [Nl*Bl, nred]
    rhs_p   = eta_p - Wt^T eta_l
    SC      = dense(Hpp) - Wt^T Ut                        [nred, nred]
    dx_p    = cholesky_solve(SC, rhs_p)
    dx_l    = planar.bmv(c_inv, eta_l - Ut dx_p)

The flat edge layout (landmark SLAM, and uniform panels past 1.5 GB), as the
JAX package's scatter branch, over chunks of landmarks:

    w       = planar.bmm(u, c_inv[col])                   [Kpl, Bp*Bl]
    rhs_p   = eta_p - segsum_row(planar.bmv(w, eta_l[col]))
    SC      = dense(Hpp) - sum over chunks W_panel U_panel^T
    dx_l    = planar.bmv(c_inv, eta_l - segsum_col(u^T dx_p[row]))

The sparse-reduced branch (slam_plus_plus_tpu/linalg/schur.py:336-470;
the reference's sparse blocky reduced solve, LinearSolver_Schur.h:1840-1849)
for a reduced system past ``sparse_reduced_limit`` dims, or panels past
2 GiB at under 5% block density (venice-real: 11.7 GiB at 0.92%), forms
SC block-sparsely on the pattern pp pairs + landmark-induced camera pairs:

    w       = planar.bmm(u, c_inv[col])                   [Kpl, Bp*Bl]
    rhs_p   = eta_p - segsum_row(planar.bmv(w, eta_l[col]))
    SC      = H_pp - segsum_sc(w[pa] u[pb]^T)             [Ksc, Bp*Bp]
    dx_p    = GraphedBlockCholeskySolver(SC pattern).solve(SC, rhs_p)
    dx_l    = planar.bmv(c_inv, eta_l - segsum_col(u^T dx_p[row]))

over every (i <= j) pair of each landmark's observations.  When the uniform
layout has one channel, every landmark has exactly M observations and the
blocks are in landmark order (mono BA without dummy slots), the clique path
replaces the gathers by broadcasts over the M slots and the pair products
by one per-landmark einsum [M*Bp, Bl] @ [Bl, M*Bp], chunked at <=
CLIQUE_CHUNK landmarks.  No Pallas kernel computes any of this in the JAX
package: the products are library matmuls and the segment sums
``index_add_``.  The solve's clique path (6 x 3 blocks, M <= 10) runs
kernels K3a and K3b instead (``ops/clique.py``): C^-1, W, the reduced rhs
and the SC pair products in one pass over the landmarks, summed on chip per
run of one camera tuple and then in a fixed order, and the
back-substitution in one more; ``_sparse_w_rhs`` and ``_sparse_sc`` keep
the torch chain for the marginals.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.linalg.chol_graph import GraphedBlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.dense import DenseScatter, cholesky_solve
from slam_plus_plus_tpu_torch.ops import clique as k3
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.ops.panel import build_panels
from slam_plus_plus_tpu_torch.utils.timer import count, enabled, span

#: reduced dims past which the JAX package forms the Schur complement
#: block-sparsely (its sparse_reduced_limit)
SPARSE_REDUCED_LIMIT = 20000
#: panel bytes past which the uniform layout takes the flat branch, and the
#: flat branch's bytes per chunk of landmarks (the JAX package's bounds)
UNIFORM_PANEL_BYTES = 3 << 29
CHUNK_PANEL_BYTES = 512 << 20
#: landmarks per chunk of the clique path's pair products (the JAX
#: package's: a chunk of [CLIQUE_CHUNK, M, M, Bp*Bp] products)
CLIQUE_CHUNK = 25000


def route_sparse_reduced(Np: int, Bp: int, Nl: int, Bl: int, Kpl: int,
                         dense_reduced=None,
                         sparse_reduced_limit: int = SPARSE_REDUCED_LIMIT) -> bool:
    """The JAX package's routing rule: form SC block-sparsely when the
    reduced system passes sparse_reduced_limit dims, or when the two dense
    panels would pass 2 GiB at under 5% block density; dense_reduced=True
    forbids it."""
    n_reduced = Np * Bp
    panel_gb = 2.0 * Nl * Bl * n_reduced * 4 / (1 << 30)
    density = (Kpl * Bp * Bl) / max(Nl * Bl * n_reduced, 1)
    return (dense_reduced is not True and
            (n_reduced > sparse_reduced_limit or (panel_gb > 2.0 and density < 0.05)))


def schur_route(Np: int, Bp: int, Nl: int, Bl: int, Kpl: int, uniform_channels: int,
                dense_reduced=None, sparse_reduced_limit: int = SPARSE_REDUCED_LIMIT) -> str:
    """The branch a Schur solve takes: "sparse" (``route_sparse_reduced``),
    else "uniform" (K2's panels) when the uniform layout has one channel
    and the two panels, counted at 4 bytes an element, fit
    UNIFORM_PANEL_BYTES, else "flat"."""
    if route_sparse_reduced(Np, Bp, Nl, Bl, Kpl, dense_reduced, sparse_reduced_limit):
        return "sparse"
    panel_bytes = 2 * Nl * Bl * Np * Bp * 4
    return "uniform" if uniform_channels == 1 and panel_bytes <= UNIFORM_PANEL_BYTES else "flat"


def _pick_chunk(Nl: int, np_bp: int, Bl: int, itemsize: int) -> int:
    """Landmark-chunk size keeping the two dense panels under
    CHUNK_PANEL_BYTES (the JAX package's rule, which counts 4 bytes per
    element; here the dtype's own)."""
    per_lm = np_bp * Bl * itemsize * 2  # U and W panels
    c = max(256, CHUNK_PANEL_BYTES // max(per_lm, 1))
    c = int(min(Nl, c))
    return ((c + 255) // 256) * 256 if c >= 256 else c


class SchurSolver:
    """Schur solve bound to an Assembler's structure and device.

    dense_reduced / sparse_reduced_limit: the JAX package's constructor
    arguments (``route_sparse_reduced``).  After construction, ``route``
    names the branch (``schur_route``), ``uniform`` says whether K2 builds
    the panels, ``sparse_reduced`` whether SC is formed block-sparsely, and
    then ``clique`` whether the clique path engaged, ``Ksc`` the number of
    SC blocks and ``reduced_chol`` the block Cholesky of the reduced system
    (its ``n_levels`` and ``plan.n_bottom``; a CUDA graph per key on the
    card, ``linalg/chol_graph.py``).  With the tracer on, each
    solve counts ``schur.route.<route>``; the uniform branch times K2 in
    the span ``schur.panels`` and counts the panels' bytes in
    ``schur.panel_bytes``; a solve that K3 serves counts
    ``schur.clique.kernel`` (``schur.clique.plain`` on the CPU) and the
    partial SC blocks K3a writes in ``schur.clique.partials``."""

    def __init__(self, asm, dense_reduced=None,
                 sparse_reduced_limit: int = SPARSE_REDUCED_LIMIT):
        self.asm = asm
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        if Nl == 0 or asm.Kpl == 0:
            raise ValueError("Schur solver requires an eliminated class")
        self.n_reduced = Np * Bp
        self.clique = False
        self._clique_plan = None
        # K2 builds one uniform channel's panels; several channels (the
        # uniform layout of a mixed or ternary scene) take the flat branch,
        # which sums the blocks of repeated (camera, landmark) pairs
        self.route = schur_route(Np, Bp, Nl, Bl, asm.Kpl, len(asm.pl_uniform or ()),
                                 dense_reduced, sparse_reduced_limit)
        self._route_counter = f"schur.route.{self.route}"
        self.sparse_reduced = self.route == "sparse"
        self.uniform = self.route == "uniform"
        if self.sparse_reduced:
            self._build_sparse_reduced()
            return
        self._dense_pp = DenseScatter(asm.pp_rows, asm.pp_cols, Np, Bp, asm.device)
        if not self.uniform:
            self._build_flat()
            return
        (ch,) = asm.pl_uniform
        self.M, self._pl_offset = ch["M"], ch["offset"]
        rows = np.asarray(ch["rows"]).reshape(Nl, self.M)
        if rows.size and (rows.min() < 0 or rows.max() >= Np):
            raise ValueError("pl block rows outside the camera range")
        self._rows_dev = torch.as_tensor(rows.astype(np.int32), device=asm.device)

    def _build_flat(self):
        """Host plan of the flat branch: pl blocks sorted by landmark, the
        chunk boundaries, and each block's flat index in its chunk's
        [nred, chunk*Bl] panel."""
        asm = self.asm
        Bp, Nl, Bl = asm.Bp, asm.Nl, asm.Bl
        self.chunk = _pick_chunk(Nl, self.n_reduced, Bl, asm.dtype.itemsize)
        n_chunks = -(-Nl // self.chunk)
        order = np.argsort(asm.pl_cols, kind="stable")
        cols = asm.pl_cols[order]
        self._starts = np.searchsorted(cols, np.arange(n_chunks + 1) * self.chunk).tolist()
        idx = planar.scatter_flat_indices(asm.pl_rows[order], cols % self.chunk, Bp, Bl,
                                          row_stride=self.chunk * Bl)

        def t(x):
            return torch.as_tensor(np.asarray(x), device=asm.device)

        self._order, self._panel_idx = t(order), t(idx)
        self._pl_rows, self._pl_cols = t(asm.pl_rows), t(asm.pl_cols)

    # ---- stages of the solve (separately callable for stage timing) ----

    def _uniform_panels(self, system):
        """(c_inv, Ut, Wt): C^-1 per landmark and the [Nl*Bl, nred] panels."""
        asm = self.asm
        Np, Bp, Nl, Bl, M = asm.Np, asm.Bp, asm.Nl, asm.Bl, self.M
        c_inv = planar.binv(system.ll_blocks, Bl)
        # a transposed view of the H_pl blocks: K2 reads it through its strides
        u4 = (system.pl_blocks[self._pl_offset:self._pl_offset + Nl * M]
              .reshape(Nl, M, Bp, Bl).transpose(2, 3))
        with span("schur.panels"):
            Ut, Wt = build_panels(u4, self._rows_dev, c_inv, Bl, Bp, Np)
        if enabled():
            count("schur.panel_bytes", Ut.nbytes + Wt.nbytes)
        return c_inv, Ut, Wt

    def _reduce(self, system, Ut, Wt):
        """(SC, rhs_p): the reduced camera system."""
        nred = self.n_reduced
        rhs = system.eta_p.reshape(nred) - Wt.T @ system.eta_l.reshape(-1)
        sc = self._dense_pp(system.pp_blocks) - Wt.T @ Ut
        return sc, rhs

    _factor_solve = staticmethod(cholesky_solve)

    def _back_substitute(self, system, c_inv, Ut, dx_flat):
        """(dx_p, dx_l): dx_l = C^-1 (eta_l - U^T dx_p)."""
        asm = self.asm
        ut_dx = (Ut @ dx_flat).reshape(asm.Nl, asm.Bl)
        dx_l = planar.bmv(c_inv, system.eta_l - ut_dx, asm.Bl, asm.Bl)
        return dx_flat.reshape(asm.Np, asm.Bp), dx_l

    def _flat_chunks(self):
        """(chunk index, lo, hi) of each non-empty chunk of the flat branch:
        its landmarks are chunk index x chunk onwards, its blocks lo:hi of
        the landmark-sorted order."""
        return [(ci, lo, hi) for ci, (lo, hi) in
                enumerate(zip(self._starts[:-1], self._starts[1:])) if hi > lo]

    def _flat_panel(self, blocks_sorted, lo, hi):
        """The [nred, chunk*Bl] dense panel of landmark-sorted pl-shaped
        blocks lo:hi."""
        Bl, C = self.asm.Bl, self.chunk
        panel = torch.zeros(self.n_reduced * C * Bl, dtype=blocks_sorted.dtype,
                            device=blocks_sorted.device)
        panel.index_add_(0, self._panel_idx[lo:hi].reshape(-1), blocks_sorted[lo:hi].reshape(-1))
        return panel.reshape(self.n_reduced, C * Bl)

    def _flat_reduce(self, system):
        """(c_inv, u, w, SC, rhs_p) of the flat branch: W = H_pl C^-1 per
        block, SC summed over the landmark chunks' dense panels."""
        asm = self.asm
        Bp, Bl = asm.Bp, asm.Bl
        rows, cols = self._pl_rows, self._pl_cols
        c_inv = planar.binv(system.ll_blocks, Bl)
        u = system.pl_blocks[:asm.Kpl]
        w = planar.bmm(u, c_inv[cols], Bp, Bl, Bl)
        rhs = system.eta_p.index_add(0, rows, planar.bmv(w, system.eta_l[cols], Bp, Bl),
                                     alpha=-1)
        sc = self._dense_pp(system.pp_blocks)
        u_sorted, w_sorted = u[self._order], w[self._order]
        for _ci, lo, hi in self._flat_chunks():
            sc = sc - self._flat_panel(w_sorted, lo, hi) @ self._flat_panel(u_sorted, lo, hi).T
        return c_inv, u, w, sc, rhs

    def _solve_flat(self, system):
        """(dx_p, dx_l) through the flat branch."""
        asm = self.asm
        Np, Bp, Bl = asm.Np, asm.Bp, asm.Bl
        c_inv, u, _w, sc, rhs = self._flat_reduce(system)
        dx_p = cholesky_solve(sc, rhs.reshape(self.n_reduced)).reshape(Np, Bp)
        rows, cols = self._pl_rows, self._pl_cols
        ut_dx = planar.bmv_At(u, dx_p[rows], Bp, Bl)
        dx_l = planar.bmv(c_inv, system.eta_l.index_add(0, cols, ut_dx, alpha=-1), Bl, Bl)
        return dx_p, dx_l

    # ---- the sparse-reduced branch -------------------------------------

    def _build_sparse_reduced(self):
        """Host plan (the JAX package's, array for array): the SC pattern =
        pp pairs + the camera pairs of each landmark's (i <= j) observation
        pairs, the pp blocks' and the pair products' SC block ids, the
        products' operands as pl block ids, their transpose flags, and the
        reduced system's block Cholesky plan."""
        asm = self.asm
        Np = asm.Np
        order = np.argsort(asm.pl_cols, kind="stable")
        rows_s = asm.pl_rows[order]
        counts = np.bincount(asm.pl_cols, minlength=asm.Nl)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pa_l, pb_l = [], []
        for d in np.unique(counts):
            if d == 0:
                continue
            g = np.flatnonzero(counts == d)
            ii, jj = np.triu_indices(d)
            base = starts[g][:, None]
            pa_l.append((base + ii[None, :]).ravel())
            pb_l.append((base + jj[None, :]).ravel())
        pa = np.concatenate(pa_l) if pa_l else np.zeros(0, dtype=np.int64)
        pb = np.concatenate(pb_l) if pb_l else np.zeros(0, dtype=np.int64)
        ra, rb = rows_s[pa], rows_s[pb]
        self.fill_flip = ra > rb
        fill_keys = np.where(self.fill_flip, rb * Np + ra, ra * Np + rb)
        pp_keys = asm.pp_rows * Np + asm.pp_cols
        self.sc_keys = np.unique(np.concatenate([pp_keys, fill_keys]))
        self.sc_rows, self.sc_cols = self.sc_keys // Np, self.sc_keys % Np
        self.pp_to_sc = np.searchsorted(self.sc_keys, pp_keys)
        self.fill_dst = np.searchsorted(self.sc_keys, fill_keys)
        self.fill_pa, self.fill_pb = order[pa], order[pb]   # pl block ids
        self.Ksc = len(self.sc_keys)
        # the JAX package's defaults: no float32 depth cap, no PCG; one
        # pattern re-factored every trial, so a CUDA graph per key
        self.reduced_chol = GraphedBlockCholeskySolver(self.sc_rows, self.sc_cols, Np,
                                                       asm.Bp, device=asm.device)

        def t(x):
            return torch.as_tensor(np.asarray(x), device=asm.device)

        self._pl_rows, self._pl_cols = t(asm.pl_rows), t(asm.pl_cols)
        self._pp_to_sc = t(self.pp_to_sc)
        self._fill_dst, self._fill_flip = t(self.fill_dst), t(self.fill_flip)
        self._fill_pa, self._fill_pb = t(self.fill_pa), t(self.fill_pb)
        # the clique path: one uniform channel, every landmark of degree M,
        # blocks in landmark order; then the fill arrays above enumerate the
        # same landmark-major triu order as np.triu_indices(M) per landmark
        # (setting ``clique`` False afterwards takes the gathered path)
        ch = asm.pl_uniform
        self.clique = bool(ch and len(ch) == 1 and len(np.unique(counts)) == 1
                           and int(counts[0]) == int(ch[0]["M"])
                           and np.array_equal(order, np.arange(len(order))))
        if self.clique:
            M = self.M = int(ch[0]["M"])
            ii, jj = np.triu_indices(M)
            self._triu = t(ii * M + jj)
            if k3.supported(M, asm.Bp, asm.Bl):
                # K3's plan: the landmarks ordered by camera tuple
                self._clique_plan = k3.build_clique_plan(
                    rows_s.reshape(asm.Nl, M), self.fill_dst, self.pp_to_sc, self.Ksc, Np,
                    asm.device)

    def _sparse_w_rhs(self, system):
        """(c_inv, u, w, rhs_p): C^-1 per landmark, the H_pl blocks, W = H_pl
        C^-1 per block and the reduced rhs eta_p - sum W eta_l."""
        asm = self.asm
        Nl, Bp, Bl = asm.Nl, asm.Bp, asm.Bl
        c_inv = planar.binv(system.ll_blocks, Bl)
        u = system.pl_blocks[:asm.Kpl]
        if self.clique:
            # broadcasts over the uniform M slots, no gathers
            M = self.M
            ci = c_inv[:, None, :].expand(Nl, M, Bl * Bl).reshape(Nl * M, Bl * Bl)
            eta = system.eta_l[:, None, :].expand(Nl, M, Bl).reshape(Nl * M, Bl)
        else:
            ci, eta = c_inv[self._pl_cols], system.eta_l[self._pl_cols]
        w = planar.bmm(u, ci, Bp, Bl, Bl)
        w_eta = torch.zeros_like(system.eta_p).index_add_(
            0, self._pl_rows, planar.bmv(w, eta, Bp, Bl))
        return c_inv, u, w, system.eta_p - w_eta

    def _sparse_sc(self, system, u, w):
        """SC [Ksc, Bp*Bp]: the pp blocks minus the pair products W_a U_b^T,
        transposed where the pair runs against the upper orientation."""
        asm = self.asm
        Nl, Bp, Bl = asm.Nl, asm.Bp, asm.Bl
        sc = torch.zeros((self.Ksc, Bp * Bp), dtype=u.dtype, device=u.device)
        sc[self._pp_to_sc] = system.pp_blocks
        if self.clique:
            M = self.M
            T = M * (M + 1) // 2
            W4, U4 = w.reshape(Nl, M, Bp, Bl), u.reshape(Nl, M, Bp, Bl)
            cl = -(-Nl // max(1, -(-Nl // CLIQUE_CHUNK)))
            for c0 in range(0, Nl, cl):
                c1 = min(c0 + cl, Nl)
                clique = torch.einsum("cmil,cnjl->cmnij", W4[c0:c1], U4[c0:c1])
                pr = clique.reshape(c1 - c0, M * M, Bp * Bp)[:, self._triu].reshape(-1, Bp * Bp)
                lo, hi = c0 * T, c1 * T       # the fill arrays are landmark-major
                pr = torch.where(self._fill_flip[lo:hi, None],
                                 planar.btranspose(pr, Bp, Bp), pr)
                sc.index_add_(0, self._fill_dst[lo:hi], pr, alpha=-1)
        else:
            pr = planar.bmm_A_Bt(w[self._fill_pa], u[self._fill_pb], Bp, Bl, Bp)
            pr = torch.where(self._fill_flip[:, None], planar.btranspose(pr, Bp, Bp), pr)
            sc.index_add_(0, self._fill_dst, pr, alpha=-1)
        return sc

    def _sparse_factor_solve(self, sc, rhs_p):
        """dx_p [Np, Bp] from the block Cholesky of SC."""
        return self.reduced_chol.solve(sc, rhs_p)

    def _sparse_back_substitute(self, system, c_inv, u, dx_p):
        """(dx_p, dx_l): dx_l = C^-1 (eta_l - sum U^T dx_p) per landmark."""
        asm = self.asm
        Nl, Bp, Bl = asm.Nl, asm.Bp, asm.Bl
        ut_dx = planar.bmv_At(u, dx_p[self._pl_rows], Bp, Bl)
        if self.clique:
            ut_dx = ut_dx.reshape(Nl, self.M, Bl).sum(1)
        else:
            ut_dx = torch.zeros_like(system.eta_l).index_add_(0, self._pl_cols, ut_dx)
        return dx_p, planar.bmv(c_inv, system.eta_l - ut_dx, Bl, Bl)

    def _solve_clique(self, system):
        """(dx_p, dx_l) through K3: K3a's pass over the landmarks (C^-1, the
        reduced rhs and SC) in ``schur.sc_fill``, the reduced factor, K3b's
        back-substitution."""
        plan = self._clique_plan
        if enabled():
            cpu = system.pl_blocks.device.type == "cpu"
            count("schur.clique.plain" if cpu else "schur.clique.kernel")
            count("schur.clique.partials", plan.n_partials)
        with span("schur.w_rhs"):
            u = system.pl_blocks[:self.asm.Kpl]
        with span("schur.sc_fill"):
            c_inv, sc, rhs_p = k3.clique_forward(system.ll_blocks, system.eta_l, u,
                                                 system.eta_p, system.pp_blocks, plan)
        with span("schur.factor"):
            dx_p = self._sparse_factor_solve(sc, rhs_p)
        with span("schur.back_substitute"):
            return dx_p, k3.clique_back(c_inv, u, system.eta_l, dx_p, plan)

    def _solve_sparse(self, system):
        if self.clique and self._clique_plan is not None:
            return self._solve_clique(system)
        with span("schur.w_rhs"):
            c_inv, u, w, rhs_p = self._sparse_w_rhs(system)
        with span("schur.sc_fill"):
            sc = self._sparse_sc(system, u, w)
        with span("schur.factor"):
            dx_p = self._sparse_factor_solve(sc, rhs_p)
        with span("schur.back_substitute"):
            return self._sparse_back_substitute(system, c_inv, u, dx_p)

    def solve(self, system):
        """(dx_p [Np, Bp], dx_l [Nl, Bl]) for a (damped) BlockSystem."""
        with span("schur.solve"):
            count(self._route_counter)
            if self.sparse_reduced:
                return self._solve_sparse(system)
            if not self.uniform:
                return self._solve_flat(system)
            with span("schur.w_rhs"):
                c_inv, Ut, Wt = self._uniform_panels(system)
            with span("schur.sc_fill"):
                sc, rhs = self._reduce(system, Ut, Wt)
            with span("schur.factor"):
                dx_flat = self._factor_solve(sc, rhs)
            with span("schur.back_substitute"):
                return self._back_substitute(system, c_inv, Ut, dx_flat)
