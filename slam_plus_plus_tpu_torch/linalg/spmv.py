"""Symmetric block-sparse matrix-vector product on the partitioned planar
lambda (port of slam_plus_plus_tpu/linalg/spmv.py::lambda_spmv, with the
index tensors built once per assembler; reference
CUberBlockMatrix::SymmetricMultiply_Add)."""

from __future__ import annotations

import torch


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
        o_p, o_l = self.columns(bs, v_p[..., None], v_l[..., None])
        return o_p[..., 0], o_l[..., 0]

    def columns(self, bs, V_p, V_l):
        """lambda @ [V_p; V_l] for m columns at once: V_p [Np, Bp, m],
        V_l [Nl, Bl, m] -> (out_p, out_l) of the same shapes."""
        Np, Bp, Nl, Bl = max(self.Np, 1), self.Bp, max(self.Nl, 1), self.Bl
        m = V_p.shape[2]
        # upper blocks: out[row] += H V[col]; mirrored: out[col] += H^T V[row]
        pp = bs.pp_blocks.reshape(-1, Bp, Bp)
        out_p = torch.zeros((Np, Bp, m), dtype=V_p.dtype, device=V_p.device)
        out_p.index_add_(0, self.rows, torch.bmm(pp, V_p[self.cols]))
        out_p.index_add_(0, self.cols, torch.bmm(pp.mT, V_p[self.rows])
                         * self.off[:, None, None].to(V_p.dtype))
        out_l = torch.zeros((Nl, Bl, m), dtype=V_p.dtype, device=V_p.device)
        if self.has_pl:
            pl = bs.pl_blocks.reshape(-1, Bp, Bl)
            out_p.index_add_(0, self.prows, torch.bmm(pl, V_l[self.pcols]))
            out_l.index_add_(0, self.pcols, torch.bmm(pl.mT, V_p[self.prows]))
        if self.Nl:
            out_l = out_l + torch.bmm(bs.ll_blocks.reshape(-1, Bl, Bl), V_l)
        return out_p, out_l
