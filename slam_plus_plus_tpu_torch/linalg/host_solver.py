"""Host-side sparse solver backend (scipy): the verification oracle.

Port of slam_plus_plus_tpu/linalg/host_solver.py.  It fills the role of the
reference's CSparse/CXSparse/CHOLMOD elementwise backends (reference
include/slam/LinearSolver_CSparse.h:49 etc.): a trusted solve to hold the
device solvers against.  It runs only when the caller asks for it
(``SolverSettings(linear_solver="scipy")``), never as a fallback.  Each
solve reads lambda and eta from their device in one transfer and returns the
step on that device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from slam_plus_plus_tpu_torch.linalg.bsr import partitioned_to_scipy


def _to_host(*tensors):
    """The tensors as numpy arrays, through one device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


class HostSparseSolver:
    """splu-based SPD solve with symbolic reuse across iterations.

    Reference analogue: CLinearSolver_UberBlock keeps the symbolic
    factorization (fill-reducing ordering + etree) across calls
    (reference include/slam/LinearSolver_UberBlock.h:272).  SuperLU does not
    expose numeric-only refactorization, so the reusable symbolic artifact
    here is the fill-reducing column ordering: computed once per sparsity
    pattern (COLAMD, via the first splu call), then re-applied as an explicit
    pre-permutation with ``permc_spec="NATURAL"`` on later factorizations of
    the same pattern.
    """

    def __init__(self):
        self._pattern_key = None
        self._perm_c = None

    def _factor(self, A: sp.csc_matrix):
        key = (A.shape[0], A.nnz, hash(A.indices.tobytes()),
               hash(A.indptr.tobytes()))
        if self._pattern_key != key:
            lu = spla.splu(A)
            self._perm_c = lu.perm_c
            self._pattern_key = key
            return lu, None
        # same pattern: reuse the cached fill-reducing ordering
        perm = self._perm_c
        lu = spla.splu(A[:, perm].tocsc(), permc_spec="NATURAL")
        return lu, perm

    def _solve_csc(self, A: sp.csc_matrix, rhs: np.ndarray) -> np.ndarray:
        lu, perm = self._factor(A)
        x = lu.solve(rhs)
        if perm is not None:
            out = np.empty_like(x)
            out[perm] = x
            return out
        return x

    def solve_partitioned(self, asm, system):
        """Solve the full [[Hpp,Hpl],[Hpl^T,Hll]] system on the host.

        Returns (dx_p [Np, Bp], dx_l [Nl, Bl]) on the system's device."""
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        pp, pl, ll, eta_p, eta_l = _to_host(system.pp_blocks, system.pl_blocks,
                                            system.ll_blocks, system.eta_p, system.eta_l)
        A = partitioned_to_scipy(
            asm.pp_rows, asm.pp_cols, pp, Np, Bp,
            asm.pl_rows if Nl else None, asm.pl_cols if Nl else None,
            pl if Nl else None, ll if Nl else None, Nl, Bl)
        rhs = np.concatenate([eta_p.ravel()[:Np * Bp], eta_l.ravel()[:Nl * Bl]])
        x = self._solve_csc(A.tocsc(), rhs)
        dx_p = x[:Np * Bp].reshape(Np, Bp)
        dx_l = x[Np * Bp:].reshape(Nl, Bl) if Nl else np.zeros((max(Nl, 1), Bl))
        like = system.eta_p
        return (torch.as_tensor(dx_p, dtype=like.dtype, device=like.device),
                torch.as_tensor(dx_l, dtype=like.dtype, device=like.device))

    def solve_blocks(self, rows, cols, blocks, rhs, Np, Bp):
        """Solve a single uniform block-sparse SPD system (upper pairs);
        blocks and rhs are tensors, the step comes back on their device."""
        blocks_h, rhs_h = _to_host(blocks, rhs)
        A = partitioned_to_scipy(rows, cols, blocks_h, Np, Bp)
        x = self._solve_csc(A.tocsc(), rhs_h.ravel()).reshape(Np, Bp)
        return torch.as_tensor(x, dtype=rhs.dtype, device=rhs.device)
