"""Schur-complement elimination of the landmark class, uniform dense branch.

Port of slam_plus_plus_tpu/linalg/schur.py::SchurSolver for the uniform
per-landmark layout (reference CLinearSolver_Schur::Solve_PosDef_Blocky,
include/slam/LinearSolver_Schur.h:1623-1849, with its dense reduced solve):

    c_inv   = planar.binv(ll)                             [Nl, Bl*Bl]
    Ut, Wt  = build_panels(...)   (kernel K2)             [Nl*Bl, nred]
    rhs_p   = eta_p - Wt^T eta_l
    SC      = dense(Hpp) - Wt^T Ut                        [nred, nred]
    dx_p    = cholesky_solve(SC, rhs_p)
    dx_l    = planar.bmv(c_inv, eta_l - Ut dx_p)

The sparse-reduced branch (many cameras, or big low-density panels) and the
scatter/one-hot panel branches for other layouts raise NotImplementedError
(ROADMAP.md Queue 1 items 11 and 13).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.ops.panel import build_panels


class SchurSolver:
    """Dense Schur solve bound to an Assembler's structure and device."""

    def __init__(self, asm):
        self.asm = asm
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        self.n_reduced = Np * Bp
        panel_bytes = 2 * Nl * Bl * self.n_reduced * 4
        density = (asm.Kpl * Bp * Bl) / max(Nl * Bl * self.n_reduced, 1)
        if panel_bytes > 2 * (1 << 30) and density < 0.05:
            raise NotImplementedError(
                "the sparse-reduced Schur branch is ROADMAP.md Queue 1 item 13")
        if panel_bytes > (3 << 29):
            raise NotImplementedError(
                "only the dense uniform panel branch is ported; the "
                "per-landmark branch is ROADMAP.md Queue 1 item 11")
        (ch,) = asm.pl_uniform
        self.M, self._pl_offset = ch["M"], ch["offset"]
        rows = np.asarray(ch["rows"]).reshape(Nl, self.M)
        if rows.size and (rows.min() < 0 or rows.max() >= Np):
            raise ValueError("pl block rows outside the camera range")
        self._rows_dev = torch.as_tensor(rows.astype(np.int32), device=asm.device)
        self._build_dense_pp_indices()

    def _build_dense_pp_indices(self):
        asm = self.asm
        Bp, dev = asm.Bp, asm.device
        # dense pp scatter: flat indices for upper blocks and their mirrors
        self._pp_idx = torch.as_tensor(planar.scatter_flat_indices(
            asm.pp_rows, asm.pp_cols, Bp, Bp, row_stride=self.n_reduced), device=dev)
        self._pp_idx_t = torch.as_tensor(planar.scatter_flat_indices(
            asm.pp_cols, asm.pp_rows, Bp, Bp, row_stride=self.n_reduced), device=dev)
        self._pp_off_mask = torch.as_tensor(
            (asm.pp_rows != asm.pp_cols).astype(np.float64), dtype=asm.dtype, device=dev)
        self._tperm = torch.as_tensor([i * Bp + j for j in range(Bp) for i in range(Bp)],
                                      device=dev)

    def _dense_pp(self, pp_blocks):
        """Planar upper block pairs -> dense symmetric [nred, nred]."""
        nred = self.n_reduced
        dense = torch.zeros(nred * nred, dtype=pp_blocks.dtype, device=pp_blocks.device)
        dense.index_add_(0, self._pp_idx.reshape(-1), pp_blocks.reshape(-1))
        mirrored = pp_blocks[:, self._tperm] * self._pp_off_mask[:, None]
        dense.index_add_(0, self._pp_idx_t.reshape(-1), mirrored.reshape(-1))
        return dense.reshape(nred, nred)

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

    @staticmethod
    def _factor_solve(sc, rhs):
        """Cholesky solve of SC dx = rhs.  A failed factorization gives NaN,
        as XLA's does in the JAX package, without a host sync."""
        L, info = torch.linalg.cholesky_ex(sc)
        L = L.masked_fill(info != 0, float("nan"))
        y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

    def _back_substitute(self, system, c_inv, Ut, dx_flat):
        """(dx_p, dx_l): dx_l = C^-1 (eta_l - U^T dx_p)."""
        asm = self.asm
        ut_dx = (Ut @ dx_flat).reshape(asm.Nl, asm.Bl)
        dx_l = planar.bmv(c_inv, system.eta_l - ut_dx, asm.Bl, asm.Bl)
        return dx_flat.reshape(asm.Np, asm.Bp), dx_l

    def solve(self, system):
        """(dx_p [Np, Bp], dx_l [Nl, Bl]) for a (damped) BlockSystem."""
        c_inv, Ut, Wt = self._uniform_panels(system)
        sc, rhs = self._reduce(system, Ut, Wt)
        return self._back_substitute(system, c_inv, Ut, self._factor_solve(sc, rhs))
