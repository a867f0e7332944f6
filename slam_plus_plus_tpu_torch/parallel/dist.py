"""Distributed lambda/eta assembly and Schur panel products over a process
group (port of slam_plus_plus_tpu/parallel/dist.py).

The reference is single-process (SURVEY.md P6: no MPI/NCCL anywhere in its
tree); this is the capability the JAX package adds over a device mesh.  In
the port each rank is one process on one device:

  * ``DistributedAssembler``: edges are the data-parallel axis.  Each rank
    holds a 1/n slice of every edge type's arrays (flat layout, padded to a
    multiple of n with zero-information edges, which add exactly zero to
    every sum while their slot ids stay in range), computes its partial
    block sums with the single-process ``_edge_sums_flat``, then one
    ``all_reduce`` sums pp / pl / ll / eta / chi2 and one max-reduce takes
    max_hdiag (the reference's OpenMP ``For_Each_Parallel`` over edge
    pools, include/slam/FlatSystem.h:932, scaled across processes).  The
    BlockSystem it returns is replicated, so every rank solves the same
    system and needs no gather before its update.
  * ``DistributedSchurSolver``: the landmark blocks, sorted by column, are
    split into n contiguous slices; each rank builds its partial dense U
    and W panels of its slice (``index_add_``) from the replicated
    BlockSystem and computes -(Wp Upᵀ), and one ``all_reduce`` sums the
    partial SC (the reference's two SpDGEMMs, LinearSolver_Schur.h:1744-1767).
    The dense Hpp, the reduced Cholesky and the landmark back-substitution
    run replicated, on the single-process SchurSolver's dense scatter.

JAX's ``make_edge_mesh`` has no counterpart: the classes take ``group=``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler, BlockSystem
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.linalg.dense import cholesky_solve
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.parallel.collectives import Collectives


def _shard(x, n: int, rank: int, fill=0):
    """Rank's slice of x's leading axis, padded with fill to a multiple of n."""
    per = -(-x.shape[0] // n)
    pad = per * n - x.shape[0]
    if pad:
        x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                     device=x.device)])
    return x[rank * per:(rank + 1) * per].contiguous()


class DistributedAssembler(Assembler):
    """Assembler whose numeric phase shards the edges over the group's
    ranks; ``assemble`` and ``chi2`` return replicated results.  The flat
    layout always: an edge shard is an arbitrary slice, while the uniform
    layout's reshape-sums need whole landmark groups."""

    def __init__(self, system, *, device, group=None,
                 settings: Optional[SolverSettings] = None, dtype=None):
        self.comm = Collectives(group)
        self.n_shards, self.rank = self.comm.size, self.comm.rank
        settings = dataclasses.replace(settings or SolverSettings(), edge_layout="flat")
        super().__init__(system, device=device, settings=settings, dtype=dtype)
        n, r = self.n_shards, self.rank
        for name, d in self.edge_data.items():
            self.edge_data[name] = dict(
                z=_shard(d["z"], n, r), info=_shard(d["info"], n, r),   # zero-info padding
                **{k: tuple(_shard(x, n, r) for x in d[k])
                   for k in ("slot_local", "slot_cslot", "pp_seg", "pp_swap", "pl_seg")})

    def assemble(self, states) -> BlockSystem:
        pp, pl, ll, eta_p, eta_l, chi2, max_hdiag = self._edge_sums_flat(states)
        pp, pl, ll, eta_p, eta_l, chi2 = self.comm.sum("assemble", pp, pl, ll, eta_p, eta_l,
                                                       chi2)
        return self._finalize(pp, pl, ll, eta_p, eta_l, chi2,
                              self.comm.max("max_hdiag", max_hdiag))

    def chi2(self, states, edge_data=None) -> torch.Tensor:
        (chi2,) = self.comm.sum("chi2", super().chi2(states, edge_data))
        return chi2


class DistributedSchurSolver:
    """Schur elimination of the landmark class with the SC panel product
    sharded over the group's ranks (each owns a contiguous slice of the
    column-sorted landmark blocks); the collective moves one [nred, nred]
    array per solve.  ``asm``: any single-process or distributed assembler
    whose BlockSystem is replicated."""

    def __init__(self, asm, *, group=None):
        if asm.Nl == 0 or asm.Kpl == 0:
            raise ValueError("Schur solver requires an eliminated class")
        self.asm = asm
        self.comm = Collectives(group)
        n, r = self.n_shards, self.rank = self.comm.size, self.comm.rank
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        self.n_reduced = Np * Bp
        order = np.argsort(asm.pl_cols, kind="stable")
        sorted_cols = asm.pl_cols[order]
        self.lm_per_shard = -(-Nl // n)
        starts = np.searchsorted(sorted_cols, np.arange(n + 1) * self.lm_per_shard)
        self.blocks_per_shard = M = int((starts[1:] - starts[:-1]).max())
        # the [n, M] tables of the JAX module: block ids, mask, and landmark
        # column relative to the shard (pad lanes: block 0, masked)
        sel = np.zeros((n, M), dtype=np.int64)
        mask = np.zeros((n, M))
        rel = np.zeros((n, M), dtype=np.int64)
        for si in range(n):
            lo, hi = starts[si], starts[si + 1]
            sel[si, :hi - lo] = order[lo:hi]
            mask[si, :hi - lo] = 1.0
            rel[si, :hi - lo] = sorted_cols[lo:hi] - si * self.lm_per_shard
        # this rank's blocks' flat indices in its [nred, lm_per_shard*Bl] panel
        idx = planar.scatter_flat_indices(asm.pl_rows[sel[r]], rel[r], Bp, Bl,
                                          row_stride=self.lm_per_shard * Bl)

        def t(x):
            return torch.as_tensor(np.asarray(x), device=asm.device)

        self._sel, self._idx = t(sel[r]), t(idx.reshape(-1))
        self._mask = t(mask[r]).to(asm.dtype)[:, None]
        self._pl_rows, self._pl_cols = t(asm.pl_rows), t(asm.pl_cols)
        self._single = SchurSolver(asm, dense_reduced=True)

    def _panel(self, blocks):
        """[nred, lm_per_shard*Bl] dense panel of this rank's blocks."""
        nred, Bl = self.n_reduced, self.asm.Bl
        p = torch.zeros(nred * self.lm_per_shard * Bl, dtype=blocks.dtype, device=blocks.device)
        p.index_add_(0, self._idx, (blocks[self._sel] * self._mask).reshape(-1))
        return p.reshape(nred, self.lm_per_shard * Bl)

    def _partial_sc(self, u, w):
        """-sum over all ranks' slices of W_panel U_panelᵀ."""
        (sc,) = self.comm.sum("sc", -(self._panel(w) @ self._panel(u).T))
        return sc

    def solve(self, bs):
        """(dx_p [Np, Bp], dx_l [Nl, Bl]), replicated."""
        asm = self.asm
        Np, Bp, Bl = asm.Np, asm.Bp, asm.Bl
        rows, cols = self._pl_rows, self._pl_cols
        c_inv = planar.binv(bs.ll_blocks, Bl)
        u = bs.pl_blocks[:asm.Kpl]
        w = planar.bmm(u, c_inv[cols], Bp, Bl, Bl)
        rhs = bs.eta_p.index_add(0, rows, planar.bmv(w, bs.eta_l[cols], Bp, Bl), alpha=-1)
        sc = self._single._dense_pp(bs.pp_blocks) + self._partial_sc(u, w)
        dx_p = cholesky_solve(sc, rhs.reshape(self.n_reduced)).reshape(Np, Bp)
        ut_dx = planar.bmv_At(u, dx_p[rows], Bp, Bl)
        dx_l = planar.bmv(c_inv, bs.eta_l.index_add(0, cols, ut_dx, alpha=-1), Bl, Bl)
        return dx_p, dx_l
