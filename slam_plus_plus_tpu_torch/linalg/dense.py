"""Dense solve of a uniform block-sparse SPD system (planar blocks).

Port of slam_plus_plus_tpu/linalg/dense.py (reference
CLinearSolver_DenseEigen, include/slam/LinearSolver_Schur.h:1046): the
planar upper block pairs are scattered into a dense symmetric matrix and
factored by one Cholesky.  The factorization and the triangular solves are
torch.linalg calls, as the JAX package calls XLA's.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.ops import planar


class DenseScatter:
    """Host-built flat indices that scatter planar upper block pairs
    [K, B*B] (rows <= cols) into a dense symmetric [N*B, N*B] matrix."""

    def __init__(self, rows, cols, N: int, B: int, device):
        rows, cols = np.asarray(rows), np.asarray(cols)
        self.n = N * B
        self.idx = torch.as_tensor(planar.scatter_flat_indices(
            rows, cols, B, B, row_stride=self.n).reshape(-1), device=device)
        self.idx_t = torch.as_tensor(planar.scatter_flat_indices(
            cols, rows, B, B, row_stride=self.n).reshape(-1), device=device)
        self.off = torch.as_tensor(rows != cols, device=device)
        self.tperm = torch.as_tensor([i * B + j for j in range(B) for i in range(B)],
                                     device=device)

    def __call__(self, blocks):
        dense = torch.zeros(self.n * self.n, dtype=blocks.dtype, device=blocks.device)
        dense.index_add_(0, self.idx, blocks.reshape(-1))
        mirrored = blocks[:, self.tperm] * self.off[:, None].to(blocks.dtype)
        dense.index_add_(0, self.idx_t, mirrored.reshape(-1))
        return dense.reshape(self.n, self.n)


def scatter_dense(rows, cols, blocks_planar, N, B):
    """Planar upper-pair block list [K, B*B] -> dense symmetric [N*B, N*B]."""
    return DenseScatter(rows, cols, N, B, blocks_planar.device)(blocks_planar)


def cholesky_solve(A, b):
    """Solve A x = b (b [n]) by Cholesky.  A failed factorization gives NaN,
    as XLA's does in the JAX package, without a host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    L = L.masked_fill(info != 0, float("nan"))
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


def solve_dense_spd(rows, cols, blocks_planar, rhs, N, B):
    """Solve the block system densely with Cholesky.  rhs: [N, B]."""
    A = scatter_dense(rows, cols, blocks_planar, N, B)
    return cholesky_solve(A, rhs.reshape(N * B)).reshape(N, B)
