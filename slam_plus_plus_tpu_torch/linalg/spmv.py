"""Symmetric block-sparse matrix-vector product on the partitioned planar
lambda (port of slam_plus_plus_tpu/linalg/spmv.py::lambda_spmv, with the
index tensors built once per assembler; reference
CUberBlockMatrix::SymmetricMultiply_Add)."""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.ops import planar


class LambdaSpmv:
    """lambda @ [v_p; v_l] for an Assembler's BlockSystem; the index
    tensors are built once on the assembler's device."""

    def __init__(self, asm):
        dev = asm.device
        self.Np, self.Bp, self.Nl, self.Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        self.rows = torch.as_tensor(asm.pp_rows, device=dev)
        self.cols = torch.as_tensor(asm.pp_cols, device=dev)
        self.off = torch.as_tensor(asm.pp_rows != asm.pp_cols, device=dev)
        self.has_pl = bool(asm.Nl and asm.Kpl)
        self.prows = torch.as_tensor(asm.pl_rows, device=dev)
        self.pcols = torch.as_tensor(asm.pl_cols, device=dev)

    def __call__(self, bs, v_p, v_l):
        """v_p [Np, Bp], v_l [Nl, Bl] -> (out_p, out_l)."""
        Np, Bp, Nl, Bl = max(self.Np, 1), self.Bp, max(self.Nl, 1), self.Bl
        # upper blocks: out[row] += H v[col]; mirrored: out[col] += H^T v[row]
        hv = planar.bmv(bs.pp_blocks, v_p[self.cols], Bp, Bp)
        out_p = torch.zeros((Np, Bp), dtype=v_p.dtype, device=v_p.device)
        out_p.index_add_(0, self.rows, hv)
        htv = planar.bmv_At(bs.pp_blocks, v_p[self.rows], Bp, Bp)
        out_p.index_add_(0, self.cols, htv * self.off[:, None].to(htv.dtype))
        out_l = torch.zeros((Nl, Bl), dtype=v_p.dtype, device=v_p.device)
        if self.has_pl:
            out_p.index_add_(0, self.prows,
                             planar.bmv(bs.pl_blocks, v_l[self.pcols], Bp, Bl))
            out_l.index_add_(0, self.pcols,
                             planar.bmv_At(bs.pl_blocks, v_p[self.prows], Bp, Bl))
        if self.Nl:
            out_l = out_l + planar.bmv(bs.ll_blocks, v_l, Bl, Bl)
        return out_p, out_l
