"""Block-sparse helpers: the partitioned block system as a scipy scalar matrix.

Port of slam_plus_plus_tpu/linalg/bsr.py (host numpy + scipy, as there).
Reference analogue: CUberBlockMatrix's CSparse interop
(p_Convert_to_Sparse / From_Sparse, reference include/slam/BlockMatrix.h:1716)
— used there, as here, for verification and host-side backends.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _expand(rows, cols, blocks, row_off, col_off, Br, Bc):
    """Block COO -> scalar COO triplets."""
    K = len(rows)
    bi = np.repeat(np.arange(Br), Bc)[None, :]
    bj = np.tile(np.arange(Bc), Br)[None, :]
    r = row_off + rows[:, None] * Br + bi
    c = col_off + cols[:, None] * Bc + bj
    v = np.asarray(blocks).reshape(K, Br * Bc)
    return r.ravel(), c.ravel(), v.ravel()


def partitioned_to_scipy(pp_rows, pp_cols, pp_blocks, Np, Bp,
                         pl_rows=None, pl_cols=None, pl_blocks=None,
                         ll_blocks=None, Nl=0, Bl=1) -> sp.csr_matrix:
    """[[Hpp, Hpl], [Hpl^T, Hll]] as a symmetric scalar CSR.

    pp holds only upper pairs (row <= col) and is symmetrized here.
    """
    rows, cols, vals = [], [], []
    # accept planar [K, Br*Bc] or 3D [K, Br, Bc] blocks
    pp_blocks = np.asarray(pp_blocks).reshape(-1, Bp, Bp)

    r, c, v = _expand(pp_rows, pp_cols, pp_blocks, 0, 0, Bp, Bp)
    rows.append(r); cols.append(c); vals.append(v)
    off = pp_rows != pp_cols
    if off.any():
        r, c, v = _expand(pp_cols[off], pp_rows[off],
                          np.swapaxes(pp_blocks[off], 1, 2), 0, 0, Bp, Bp)
        rows.append(r); cols.append(c); vals.append(v)

    n = Np * Bp + Nl * Bl
    if Nl:
        l_off = Np * Bp
        if pl_rows is not None and len(pl_rows):
            pl_blocks = np.asarray(pl_blocks).reshape(-1, Bp, Bl)
            r, c, v = _expand(pl_rows, pl_cols, pl_blocks, 0, 0, Bp, Bl)
            c = c + l_off  # _expand gave pl_cols * Bl; add the landmark base
            rows.append(r); cols.append(c); vals.append(v)
            r2, c2, v2 = _expand(pl_cols, pl_rows,
                                 np.swapaxes(pl_blocks, 1, 2), 0, 0, Bl, Bp)
            rows.append(r2 + l_off); cols.append(c2); vals.append(v2)
        diag_ids = np.arange(Nl, dtype=np.int64)
        r, c, v = _expand(diag_ids, diag_ids, np.asarray(ll_blocks), l_off, l_off, Bl, Bl)
        rows.append(r); cols.append(c); vals.append(v)

    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n)).tocsr()


def block_system_to_scipy(asm, bs) -> sp.csr_matrix:
    """The lambda of an Assembler's BlockSystem as a symmetric scalar CSR on
    the host: one ``.cpu()`` per block array, then partitioned_to_scipy."""
    landmarks = bool(asm.Nl)
    return partitioned_to_scipy(
        asm.pp_rows, asm.pp_cols, bs.pp_blocks.cpu().numpy(), asm.Np, asm.Bp,
        asm.pl_rows if landmarks else None, asm.pl_cols if landmarks else None,
        bs.pl_blocks.cpu().numpy() if landmarks else None,
        bs.ll_blocks.cpu().numpy() if landmarks else None, asm.Nl, asm.Bl)
