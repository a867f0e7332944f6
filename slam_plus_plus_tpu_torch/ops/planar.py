"""Planar (flattened) small-block linear algebra, batched in torch.

Port of slam_plus_plus_tpu/ops/planar.py.  Blocks keep the JAX package's
planar layout ``[K, Br*Bc]`` (row-major block flattened on the last axis),
so the port's block systems compare field by field with the JAX ones.
"""

from __future__ import annotations

import torch


def bmm(a, b, Br: int, Bm: int, Bc: int):
    """Per-block matmul: a [K, Br*Bm] @ b [K, Bm*Bc] -> [K, Br*Bc]."""
    K = a.shape[0]
    return torch.bmm(a.reshape(K, Br, Bm), b.reshape(K, Bm, Bc)).reshape(K, Br * Bc)


def bmm_At_B(a, b, Br: int, Bm: int, Bc: int):
    """Per-block a^T @ b: a [K, Bm*Br], b [K, Bm*Bc] -> [K, Br*Bc]."""
    K = a.shape[0]
    return torch.bmm(a.reshape(K, Bm, Br).transpose(1, 2),
                     b.reshape(K, Bm, Bc)).reshape(K, Br * Bc)


def bmm_A_Bt(a, b, Br: int, Bm: int, Bc: int):
    """Per-block a @ b^T: a [K, Br*Bm], b [K, Bc*Bm] -> [K, Br*Bc]."""
    K = a.shape[0]
    return torch.bmm(a.reshape(K, Br, Bm),
                     b.reshape(K, Bc, Bm).transpose(1, 2)).reshape(K, Br * Bc)


def bmv_At(a, v, Br: int, Bc: int):
    """Per-block a^T @ v: a [K, Br*Bc], v [K, Br] -> [K, Bc]."""
    K = a.shape[0]
    return torch.bmm(v.reshape(K, 1, Br), a.reshape(K, Br, Bc)).reshape(K, Bc)


def btranspose(a, Br: int, Bc: int):
    """Per-block transpose: [K, Br*Bc] -> [K, Bc*Br]."""
    K = a.shape[0]
    return a.reshape(K, Br, Bc).transpose(1, 2).reshape(K, Bc * Br)


def bdiag(a, B: int):
    """Per-block diagonal: [K, B*B] -> [K, B]."""
    return a[:, ::B + 1]


def badd_diag(a, alpha, B: int):
    """Per-block a + alpha*I: alpha a scalar or [K]; only the diagonal
    entries change."""
    out = a.clone()
    alpha = torch.as_tensor(alpha, dtype=a.dtype, device=a.device)
    out[:, ::B + 1] += alpha[:, None] if alpha.ndim else alpha
    return out


def bmv(a, v, Br: int, Bc: int):
    """Per-block matvec: a [K, Br*Bc] @ v [K, Bc] -> [K, Br]."""
    K = a.shape[0]
    return torch.bmm(a.reshape(K, Br, Bc), v.reshape(K, Bc, 1)).reshape(K, Br)


def binv(a, B: int):
    """Per-block inverse, a [K, B*B] planar.

    B <= 3 by the unrolled adjugate (an exactly symmetric result for a
    symmetric input); larger blocks by recursive 2x2 block inversion through
    the Schur complement, which needs SPD blocks (lambda pivots are).
    """
    if B == 1:
        return 1.0 / a
    if B == 2:
        a11, a12, a21, a22 = a.unbind(1)
        inv_det = 1.0 / (a11 * a22 - a12 * a21)
        return torch.stack([a22 * inv_det, -a12 * inv_det,
                            -a21 * inv_det, a11 * inv_det], dim=1)
    if B == 3:
        (a11, a12, a13,
         a21, a22, a23,
         a31, a32, a33) = a.unbind(1)
        c11 = a22 * a33 - a23 * a32
        c12 = a13 * a32 - a12 * a33
        c13 = a12 * a23 - a13 * a22
        c21 = a23 * a31 - a21 * a33
        c22 = a11 * a33 - a13 * a31
        c23 = a13 * a21 - a11 * a23
        c31 = a21 * a32 - a22 * a31
        c32 = a12 * a31 - a11 * a32
        c33 = a11 * a22 - a12 * a21
        det = a11 * c11 + a12 * c21 + a13 * c31
        inv_det = 1.0 / det
        return torch.stack([c11, c12, c13, c21, c22, c23, c31, c32, c33],
                           dim=1) * inv_det[:, None]
    B1 = B // 2
    B2 = B - B1

    def sub(i0, j0, Br, Bc):
        # a strided view, copied: no index tensor to upload (a CUDA graph
        # cannot capture that upload)
        return a.reshape(-1, B, B)[:, i0:i0 + Br, j0:j0 + Bc].reshape(-1, Br * Bc)

    A11 = sub(0, 0, B1, B1)
    A12 = sub(0, B1, B1, B2)
    A21 = sub(B1, 0, B2, B1)
    A22 = sub(B1, B1, B2, B2)
    A11i = binv(A11, B1)
    # S = A22 - A21 A11^-1 A12
    T = bmm(A21, A11i, B2, B1, B1)
    Si = binv(A22 - bmm(T, A12, B2, B1, B2), B2)
    I12 = -bmm(bmm(A11i, A12, B1, B1, B2), Si, B1, B2, B2)
    I21 = -bmm(Si, T, B2, B2, B1)
    I11 = A11i - bmm(I12, T, B1, B2, B1)
    K = a.shape[0]
    top = torch.cat([I11.reshape(K, B1, B1), I12.reshape(K, B1, B2)], dim=2)
    bottom = torch.cat([I21.reshape(K, B2, B1), Si.reshape(K, B2, B2)], dim=2)
    return torch.cat([top, bottom], dim=1).reshape(K, B * B)


def scatter_flat_indices(rows, cols, Br: int, Bc: int, row_stride: int):
    """Host-side: flat indices of planar blocks in a row-major dense target
    [n_rows, row_stride].  rows/cols: [K] numpy block coordinates.
    Returns [K, Br*Bc] int64 numpy."""
    import numpy as np
    base = (rows.astype(np.int64) * Br)[:, None] * row_stride + \
        (cols.astype(np.int64) * Bc)[:, None]
    off = np.array([i * row_stride + j for i in range(Br) for j in range(Bc)],
                   dtype=np.int64)
    return base + off[None, :]
