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

The sparse-reduced branch (a reduced system past 20,000 dims, or big
low-density panels) raises NotImplementedError (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.linalg.dense import DenseScatter, cholesky_solve
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.ops.panel import build_panels

#: reduced dims past which the JAX package forms the Schur complement
#: block-sparsely (its sparse_reduced_limit)
SPARSE_REDUCED_LIMIT = 20000
#: panel bytes past which the uniform layout takes the flat branch, and the
#: flat branch's bytes per chunk of landmarks (the JAX package's bounds)
UNIFORM_PANEL_BYTES = 3 << 29
CHUNK_PANEL_BYTES = 512 << 20


def _pick_chunk(Nl: int, np_bp: int, Bl: int) -> int:
    """Landmark-chunk size keeping the two dense panels under
    CHUNK_PANEL_BYTES (the JAX package's rule)."""
    per_lm = np_bp * Bl * 4 * 2  # U and W panels, f32
    c = max(256, CHUNK_PANEL_BYTES // max(per_lm, 1))
    c = int(min(Nl, c))
    return ((c + 255) // 256) * 256 if c >= 256 else c


class SchurSolver:
    """Dense Schur solve bound to an Assembler's structure and device."""

    def __init__(self, asm):
        self.asm = asm
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        self.n_reduced = Np * Bp
        panel_bytes = 2 * Nl * Bl * self.n_reduced * 4
        density = (asm.Kpl * Bp * Bl) / max(Nl * Bl * self.n_reduced, 1)
        if self.n_reduced > SPARSE_REDUCED_LIMIT or (panel_bytes > 2 * (1 << 30)
                                                      and density < 0.05):
            raise NotImplementedError(
                "the sparse-reduced Schur branch is ROADMAP.md Queue 1 item 13")
        self._dense_pp = DenseScatter(asm.pp_rows, asm.pp_cols, Np, Bp, asm.device)
        self.uniform = asm.pl_uniform is not None and panel_bytes <= UNIFORM_PANEL_BYTES
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
        self.chunk = _pick_chunk(Nl, self.n_reduced, Bl)
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
        Ut, Wt = build_panels(u4, self._rows_dev, c_inv, Bl, Bp, Np)
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

    def _solve_flat(self, system):
        """(dx_p, dx_l) through the flat branch."""
        asm = self.asm
        Np, Bp, Nl, Bl, C = asm.Np, asm.Bp, asm.Nl, asm.Bl, self.chunk
        nred = self.n_reduced
        rows, cols = self._pl_rows, self._pl_cols
        c_inv = planar.binv(system.ll_blocks, Bl)
        u = system.pl_blocks[:asm.Kpl]
        w = planar.bmm(u, c_inv[cols], Bp, Bl, Bl)
        rhs = system.eta_p.index_add(0, rows, planar.bmv(w, system.eta_l[cols], Bp, Bl),
                                     alpha=-1)
        sc = self._dense_pp(system.pp_blocks)
        u_sorted, w_sorted = u[self._order], w[self._order]
        for lo, hi in zip(self._starts[:-1], self._starts[1:]):
            if hi == lo:
                continue
            idx = self._panel_idx[lo:hi].reshape(-1)
            panels = []
            for blocks in (w_sorted[lo:hi], u_sorted[lo:hi]):
                panel = torch.zeros(nred * C * Bl, dtype=u.dtype, device=u.device)
                panels.append(panel.index_add_(0, idx, blocks.reshape(-1)).reshape(nred, C * Bl))
            sc = sc - panels[0] @ panels[1].T
        dx_p = cholesky_solve(sc, rhs.reshape(nred)).reshape(Np, Bp)
        ut_dx = planar.bmv_At(u, dx_p[rows], Bp, Bl)
        dx_l = planar.bmv(c_inv, system.eta_l.index_add(0, cols, ut_dx, alpha=-1), Bl, Bl)
        return dx_p, dx_l

    def solve(self, system):
        """(dx_p [Np, Bp], dx_l [Nl, Bl]) for a (damped) BlockSystem."""
        if not self.uniform:
            return self._solve_flat(system)
        c_inv, Ut, Wt = self._uniform_panels(system)
        sc, rhs = self._reduce(system, Ut, Wt)
        return self._back_substitute(system, c_inv, Ut, self._factor_solve(sc, rhs))
