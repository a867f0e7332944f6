"""General block-matrix toolkit — the ÜberBlockMatrix API surface.

Port of slam_plus_plus_tpu/linalg/block_matrix.py, numpy/scipy on the host
as there (reference CUberBlockMatrix, include/slam/BlockMatrix.h): blocks of
mixed sizes, slicing and permutation, block LU, MatrixMarket load and save,
the VBR export and the structure-diff raster (BlockMatrix.h:253-335).  The
solvers never touch it (they run on ops/planar.py and
linalg/block_cholesky.py); it serves tools, tests and interop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp


class BlockMatrix:
    """Sparse block matrix with heterogeneous block sizes.

    Layout: ``row_sizes``/``col_sizes`` give the block-row/column heights/
    widths (reference: the block row/column lists, BlockMatrix.h:178);
    blocks live in a dict ``{(bi, bj): ndarray[h, w]}``.
    """

    def __init__(self, row_sizes: Sequence[int], col_sizes: Sequence[int]):
        self.row_sizes = list(int(s) for s in row_sizes)
        self.col_sizes = list(int(s) for s in col_sizes)
        self.row_offsets = np.concatenate([[0], np.cumsum(self.row_sizes)])
        self.col_offsets = np.concatenate([[0], np.cumsum(self.col_sizes)])
        self.blocks: Dict[Tuple[int, int], np.ndarray] = {}

    # ---- construction ---------------------------------------------------

    def set_block(self, bi: int, bj: int, block) -> "BlockMatrix":
        block = np.asarray(block, dtype=np.float64)
        expect = (self.row_sizes[bi], self.col_sizes[bj])
        if block.shape != expect:
            raise ValueError(f"block ({bi},{bj}): {block.shape} != {expect}")
        self.blocks[(bi, bj)] = block
        return self

    def add_to_block(self, bi: int, bj: int, block) -> "BlockMatrix":
        cur = self.blocks.get((bi, bj))
        if cur is None:
            return self.set_block(bi, bj, block)
        self.blocks[(bi, bj)] = cur + np.asarray(block, dtype=np.float64)
        return self

    @property
    def shape(self) -> Tuple[int, int]:
        return int(self.row_offsets[-1]), int(self.col_offsets[-1])

    @classmethod
    def from_dense(cls, dense, row_sizes, col_sizes,
                   drop_zero_blocks=True) -> "BlockMatrix":
        m = cls(row_sizes, col_sizes)
        dense = np.asarray(dense)
        for bi in range(len(m.row_sizes)):
            r0, r1 = m.row_offsets[bi], m.row_offsets[bi + 1]
            for bj in range(len(m.col_sizes)):
                c0, c1 = m.col_offsets[bj], m.col_offsets[bj + 1]
                blk = dense[r0:r1, c0:c1]
                if not drop_zero_blocks or np.any(blk):
                    m.set_block(bi, bj, blk)
        return m

    # ---- conversions ----------------------------------------------------

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        for (bi, bj), blk in self.blocks.items():
            out[self.row_offsets[bi]:self.row_offsets[bi + 1],
                self.col_offsets[bj]:self.col_offsets[bj + 1]] = blk
        return out

    def to_csr(self) -> sp.csr_matrix:
        rows, cols, vals = [], [], []
        for (bi, bj), blk in self.blocks.items():
            h, w = blk.shape
            r = self.row_offsets[bi] + np.repeat(np.arange(h), w)
            c = self.col_offsets[bj] + np.tile(np.arange(w), h)
            rows.append(r); cols.append(c); vals.append(blk.ravel())
        if not rows:
            return sp.csr_matrix(self.shape)
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=self.shape).tocsr()

    def to_vbr(self):
        """Variable Block Row export (reference t_VBR, BlockMatrix.h VBR
        support): returns (rpntr, cpntr, bpntrb, bpntre, indx, bindx, val)
        in the classic SPARSKIT VBR convention."""
        nb_r, nb_c = len(self.row_sizes), len(self.col_sizes)
        rpntr = self.row_offsets.astype(np.int64)
        cpntr = self.col_offsets.astype(np.int64)
        bindx, indx, val = [], [0], []
        bpntrb, bpntre = [], []
        for bi in range(nb_r):
            bpntrb.append(len(bindx))
            for bj in range(nb_c):
                blk = self.blocks.get((bi, bj))
                if blk is None:
                    continue
                bindx.append(bj)
                val.append(blk.ravel(order="F"))   # VBR stores column-major
                indx.append(indx[-1] + blk.size)
            bpntre.append(len(bindx))
        return (rpntr, cpntr, np.asarray(bpntrb), np.asarray(bpntre),
                np.asarray(indx), np.asarray(bindx),
                np.concatenate(val) if val else np.zeros(0))

    # ---- structural ops -------------------------------------------------

    def transpose(self) -> "BlockMatrix":
        out = BlockMatrix(self.col_sizes, self.row_sizes)
        for (bi, bj), blk in self.blocks.items():
            out.set_block(bj, bi, blk.T)
        return out

    def slice(self, row_range: Tuple[int, int],
              col_range: Tuple[int, int]) -> "BlockMatrix":
        """Sub-matrix of whole block rows/cols [r0, r1) x [c0, c1)
        (reference SliceTo, BlockMatrix.h:1069)."""
        r0, r1 = row_range
        c0, c1 = col_range
        out = BlockMatrix(self.row_sizes[r0:r1], self.col_sizes[c0:c1])
        for (bi, bj), blk in self.blocks.items():
            if r0 <= bi < r1 and c0 <= bj < c1:
                out.set_block(bi - r0, bj - c0, blk)
        return out

    def permute(self, row_perm: Optional[Sequence[int]] = None,
                col_perm: Optional[Sequence[int]] = None) -> "BlockMatrix":
        """Symmetric/general block permutation: out[i, j] =
        self[row_perm[i], col_perm[j]] (reference
        Permute_UpperTriangular_To, BlockMatrix.h:1231)."""
        rp = list(row_perm) if row_perm is not None else \
            list(range(len(self.row_sizes)))
        cp = list(col_perm) if col_perm is not None else \
            list(range(len(self.col_sizes)))
        inv_r = {o: n for n, o in enumerate(rp)}
        inv_c = {o: n for n, o in enumerate(cp)}
        out = BlockMatrix([self.row_sizes[i] for i in rp],
                          [self.col_sizes[j] for j in cp])
        for (bi, bj), blk in self.blocks.items():
            if bi in inv_r and bj in inv_c:
                out.set_block(inv_r[bi], inv_c[bj], blk)
        return out

    # ---- algebra --------------------------------------------------------

    def matmul(self, other: "BlockMatrix") -> "BlockMatrix":
        """Block SpGEMM (reference MultiplyToWith, BlockMatrix.h:2430)."""
        if self.col_sizes != other.row_sizes:
            raise ValueError("block dimension mismatch")
        out = BlockMatrix(self.row_sizes, other.col_sizes)
        by_row: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        for (bk, bj), blk in other.blocks.items():
            by_row.setdefault(bk, []).append((bj, blk))
        for (bi, bk), a in self.blocks.items():
            for bj, b in by_row.get(bk, ()):
                out.add_to_block(bi, bj, a @ b)
        return out

    def add(self, other: "BlockMatrix") -> "BlockMatrix":
        if (self.row_sizes != other.row_sizes or
                self.col_sizes != other.col_sizes):
            raise ValueError("layout mismatch")
        out = BlockMatrix(self.row_sizes, self.col_sizes)
        for (k, blk) in self.blocks.items():
            out.set_block(*k, blk)
        for (k, blk) in other.blocks.items():
            out.add_to_block(*k, blk)
        return out

    def lu(self):
        """Block LU with block-level partial pivoting (reference
        LUTo/iLUTo, BlockMatrix.h LU support).  Requires a square block
        grid with uniform square diagonal blocks per position.  Returns
        (P, L, U) as BlockMatrix with P a block permutation list such that
        A[P] = L @ U."""
        n = len(self.row_sizes)
        if self.row_sizes != self.col_sizes:
            raise ValueError("block LU requires a square block layout")
        work: Dict[Tuple[int, int], np.ndarray] = {
            k: blk.copy() for k, blk in self.blocks.items()}
        perm = list(range(n))

        def get(i, j):
            return work.get((i, j))

        for k in range(n):
            # block partial pivot: row with the best-conditioned pivot
            best, best_i = -1.0, -1
            for i in range(k, n):
                blk = get(i, k)
                if blk is None or blk.shape[0] != blk.shape[1]:
                    continue
                s = np.linalg.svd(blk, compute_uv=False)
                score = s[-1]
                if score > best:
                    best, best_i = score, i
            if best_i < 0 or best <= 0:
                raise np.linalg.LinAlgError(f"structurally singular at {k}")
            if best_i != k:
                perm[k], perm[best_i] = perm[best_i], perm[k]
                for j in range(n):
                    a, b = work.pop((k, j), None), work.pop((best_i, j), None)
                    if b is not None:
                        work[(k, j)] = b
                    if a is not None:
                        work[(best_i, j)] = a
            piv = get(k, k)
            piv_inv = np.linalg.inv(piv)
            for i in range(k + 1, n):
                aik = get(i, k)
                if aik is None:
                    continue
                lik = aik @ piv_inv
                work[(i, k)] = lik
                for j in range(k + 1, n):
                    akj = get(k, j)
                    if akj is not None:
                        cur = work.get((i, j))
                        upd = lik @ akj
                        work[(i, j)] = (cur - upd) if cur is not None else -upd

        L = BlockMatrix(self.row_sizes, self.col_sizes)
        U = BlockMatrix(self.row_sizes, self.col_sizes)
        for i in range(n):
            L.set_block(i, i, np.eye(self.row_sizes[i]))
        for (i, j), blk in work.items():
            (L if i > j else U).set_block(i, j, blk)
        return perm, L, U

    # ---- I/O ------------------------------------------------------------

    def save_matrix_market(self, path, comment="block matrix"):
        A = self.to_csr().tocoo()
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n")
            f.write(f"% {comment}\n")
            f.write(f"%%block-layout rows "
                    f"{' '.join(map(str, self.row_sizes))} cols "
                    f"{' '.join(map(str, self.col_sizes))}\n")
            f.write(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n")
            for r, c, v in zip(A.row, A.col, A.data):
                f.write(f"{r + 1} {c + 1} {v:.17g}\n")

    @classmethod
    def load_matrix_market(cls, path, row_sizes=None,
                           col_sizes=None) -> "BlockMatrix":
        """MatrixMarket LOAD (reference Load_MatrixMarket,
        BlockMatrix.h:3802) — reads coordinate real general/symmetric; the
        block layout comes from the %%block-layout comment written by
        :meth:`save_matrix_market` or the explicit arguments (falling back
        to 1x1 scalar blocks)."""
        sym = False
        rows, cols, vals = [], [], []
        header = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("%"):
                    if "symmetric" in line:
                        sym = True
                    if line.startswith("%%block-layout") and row_sizes is None:
                        toks = line.split()
                        ci = toks.index("cols")
                        row_sizes = [int(x) for x in toks[2:ci]]
                        col_sizes = [int(x) for x in toks[ci + 1:]]
                    continue
                toks = line.split()
                if header is None:
                    header = (int(toks[0]), int(toks[1]))
                    continue
                rows.append(int(toks[0]) - 1)
                cols.append(int(toks[1]) - 1)
                vals.append(float(toks[2]))
        n, m = header
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, m))
        if sym:
            off = A.row != A.col
            A = sp.coo_matrix(
                (np.concatenate([A.data, A.data[off]]),
                 (np.concatenate([A.row, A.col[off]]),
                  np.concatenate([A.col, A.row[off]]))), shape=(n, m))
        if row_sizes is None:
            row_sizes = [1] * n
            col_sizes = [1] * m
        if col_sizes is None:
            col_sizes = row_sizes
        return cls.from_dense(A.toarray(), row_sizes, col_sizes)

    # ---- rasterization --------------------------------------------------

    def occupancy(self) -> np.ndarray:
        """Block-level occupancy image (1 = block present)."""
        img = np.zeros((len(self.row_sizes), len(self.col_sizes)))
        for (bi, bj) in self.blocks:
            img[bi, bj] = 1.0
        return img

    def rasterize_diff(self, prev: "BlockMatrix") -> np.ndarray:
        """Structure/value diff image (reference Rasterize with
        p_prev_state, BlockMatrix.h:303): 0 = absent, 1 = unchanged,
        2 = value-changed, 3 = new block, 4 = removed block."""
        if (self.row_sizes != prev.row_sizes or
                self.col_sizes != prev.col_sizes):
            raise ValueError("layout mismatch")
        img = np.zeros((len(self.row_sizes), len(self.col_sizes)),
                       dtype=np.int8)
        for k, blk in self.blocks.items():
            p = prev.blocks.get(k)
            if p is None:
                img[k] = 3
            elif np.array_equal(p, blk):
                img[k] = 1
            else:
                img[k] = 2
        for k in prev.blocks:
            if k not in self.blocks:
                img[k] = 4
        return img


def from_partitioned(asm, bs) -> BlockMatrix:
    """The assembler's partitioned lambda (a BlockSystem on any device) as
    a general BlockMatrix, symmetrized."""
    Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
    m = BlockMatrix([Bp] * Np + [Bl] * Nl, [Bp] * Np + [Bl] * Nl)
    pp = bs.pp_blocks.detach().cpu().double().numpy().reshape(-1, Bp, Bp)
    for k, (r, c) in enumerate(zip(asm.pp_rows, asm.pp_cols)):
        m.add_to_block(int(r), int(c), pp[k])
        if r != c:
            m.add_to_block(int(c), int(r), pp[k].T)
    if Nl:
        pl = bs.pl_blocks.detach().cpu().double().numpy().reshape(-1, Bp, Bl)
        for k, (r, c) in enumerate(zip(asm.pl_rows, asm.pl_cols)):
            if np.any(pl[k]):
                m.add_to_block(int(r), Np + int(c), pl[k])
                m.add_to_block(Np + int(c), int(r), pl[k].T)
        ll = bs.ll_blocks.detach().cpu().double().numpy().reshape(-1, Bl, Bl)
        for c in range(Nl):
            m.add_to_block(Np + c, Np + c, ll[c])
    return m
