"""Truncated symmetric eigensolver over the block system.

Port of slam_plus_plus_tpu/linalg/eigen.py (reference CSymEigsSolver /
CSymEigsShiftSolver, include/slam/Eigenvalues.h:179,378 — Lanczos with
implicit restarts, used for gauge / conditioning analysis and the
slam_schur_orderings research tool).

Routes, as in the JAX package: a dense host eigendecomposition up to
``_DENSE_LIMIT`` scalar dims or for "SM"; above it a matrix-free LOBPCG
over the block SpMV (``LambdaSpmv.columns``).  ``torch.lobpcg`` takes a
matrix, not an operator, so the port carries its own ``lobpcg_standard``:
the counterpart of ``jax.experimental.sparse.linalg.lobpcg_standard(A, X,
m)`` — Rayleigh–Ritz on the orthonormal block [X, P, R], largest
eigenvalues first, SVQB orthonormalization, the same convergence test.
``condition_estimate`` runs it over an inverse operator: one
BlockCholeskySolver factor for pose-only systems, block-Jacobi PCG for
systems with landmarks.

The operator and the iteration stay on the block system's device and in
its dtype (run them in float64: shift-invert through a float32 factor
would see its ridge, not lambda); the LOBPCG loop reads one scalar (the
converged count) per iteration.  Random starts come from
``np.random.default_rng(0)`` and ``default_rng(1)``, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slam_plus_plus_tpu_torch.linalg.bsr import block_system_to_scipy
from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv
from slam_plus_plus_tpu_torch.ops import planar

_DENSE_LIMIT = 2000
#: inner PCG of the landmark route (the JAX package's jax.scipy cg settings)
CG_TOL = 1e-9
#: the inner PCG checks its stop test every CG_CHECK_EVERY iterations
CG_CHECK_EVERY = 32


def _dense_lambda(asm, bs) -> np.ndarray:
    return block_system_to_scipy(asm, bs).toarray()


# ----------------------------------------------------------------------
# LOBPCG over a callable (jax.experimental.sparse.linalg.lobpcg_standard)
# ----------------------------------------------------------------------

def _eigh_descending(A):
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """Truncated orthonormal basis of X (SVQB): columns found degenerate
    come back zero."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = torch.linalg.vector_norm(ortho, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):      # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis, U):
    """U's component orthogonal to the orthonormal (zero columns allowed)
    basis; suspicious columns are zeroed so [basis, U] stays orthogonal."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.vector_norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _extend_basis(X, m):
    """m more orthonormal directions beside the orthonormal X [n, k], by a
    block Householder reflector (deterministic)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(A, X, m: int = 100):
    """Top-k (largest) eigenpairs of the symmetric operator A (a callable
    [n, j] -> [n, j]) from the start X [n, k]: (theta [k], U [n, k],
    iterations).  A pair converges when |A v - theta v| < eps * 10 * n *
    (theta + |A v|), eps the dtype's epsilon (the JAX function's default
    tol); the loop stops when all k have, or after m iterations."""
    n, k = X.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"need 0 < 5 k < n, got k={k}, n={n}")
    tol = float(torch.finfo(X.dtype).eps)
    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0)
    R = AX - theta[None, :] * X
    i, converged = 0, 0
    while i < m and converged < k:
        R = _project_out(torch.cat([X, P], dim=1), R)
        XPR = torch.cat([X, P, R], dim=1)
        theta, Q = _eigh_descending(XPR.T @ A(XPR))       # Rayleigh-Ritz
        B = Q[:, :k]
        B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.vector_norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, 1.0, normP)
        AX = A(X)
        R = AX - theta[None, :k] * X
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int((torch.linalg.vector_norm(R, dim=0) < tol * reltol).sum())
        i += 1
    return theta[:k], X, i


# ----------------------------------------------------------------------
# operators on the partitioned block system
# ----------------------------------------------------------------------

class _Columns:
    """Split / join [n, m] columns into the block system's pose and
    landmark parts."""

    def __init__(self, asm):
        self.Np, self.Bp, self.Nl, self.Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        self.n_p = asm.Np * asm.Bp

    def split(self, X):
        m = X.shape[1]
        V_p = X[:self.n_p].reshape(self.Np, self.Bp, m)
        V_l = (X[self.n_p:].reshape(self.Nl, self.Bl, m) if self.Nl
               else torch.zeros((1, self.Bl, m), dtype=X.dtype, device=X.device))
        return V_p, V_l

    def join(self, O_p, O_l):
        m = O_p.shape[2]
        parts = [O_p.reshape(-1, m)]
        if self.Nl:
            parts.append(O_l.reshape(-1, m))
        return torch.cat(parts, dim=0)


def lambda_operator(asm, bs):
    """X [n, m] -> lambda X through the block SpMV."""
    spmv, cols = LambdaSpmv(asm), _Columns(asm)
    return lambda X: cols.join(*spmv.columns(bs, *cols.split(X)))


def sym_eigs(asm, bs, k: int = 6, which: str = "LM",
             max_iters: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k eigenvalues/eigenvectors of the (symmetric) lambda.

    which: "LM" largest magnitude | "SM" smallest magnitude (dense).
    Returns (eigenvalues [k], eigenvectors [n, k]) as host numpy."""
    n = asm.Np * asm.Bp + asm.Nl * asm.Bl

    if n <= _DENSE_LIMIT or which == "SM":
        # smallest-magnitude needs an inverse operator; for the problem sizes
        # where conditioning analysis is run (research tool), dense is exact
        A = _dense_lambda(asm, bs)
        w, V = np.linalg.eigh(A)
        order = np.argsort(np.abs(w))
        idx = order[::-1][:k] if which == "LM" else order[:k]
        return w[idx], V[:, idx]

    rng = np.random.default_rng(0)
    X0 = torch.as_tensor(rng.normal(0, 1, (n, k)), dtype=bs.eta_p.dtype,
                         device=bs.eta_p.device)
    w, V, _ = lobpcg_standard(lambda_operator(asm, bs), X0, m=max_iters)
    order = torch.argsort(-torch.abs(w))
    return w[order].cpu().numpy(), V[:, order].cpu().numpy()


def _block_jacobi(asm, bs):
    """X [n, m] -> the inverse diagonal blocks of lambda applied to X (the
    SPCG solver's preconditioner)."""
    cols = _Columns(asm)
    pd_inv = planar.binv(bs.pp_blocks[asm.pp_diag_ids_dev], asm.Bp).reshape(-1, asm.Bp, asm.Bp)
    ll_inv = (planar.binv(bs.ll_blocks, asm.Bl).reshape(-1, asm.Bl, asm.Bl)
              if asm.Nl else None)

    def apply(X):
        V_p, V_l = cols.split(X)
        return cols.join(torch.bmm(pd_inv, V_p),
                         torch.bmm(ll_inv, V_l) if ll_inv is not None else V_l)
    return apply


def _pcg_columns(A, M, Bm, tol: float, maxiter: int):
    """A^-1 Bm column by column by preconditioned CG, all columns in one
    batch (a converged column stops moving), stopping when every column's
    |r| <= tol |b| or after maxiter iterations; the stop test is read
    every CG_CHECK_EVERY iterations."""
    x = torch.zeros_like(Bm)
    r = Bm.clone()
    z = M(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    goal = (tol * torch.linalg.vector_norm(Bm, dim=0)) ** 2
    for it in range(maxiter):
        active = torch.sum(r * r, dim=0) > goal
        if it % CG_CHECK_EVERY == 0 and not bool(active.any()):
            break
        Ap = A(p)
        alpha = torch.where(active, rz / torch.sum(p * Ap, dim=0), 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = M(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(active, rz_new / rz, 0.0)
        p = torch.where(active[None, :], z + beta[None, :] * p, p)
        rz = torch.where(active, rz_new, rz)
    return x


def condition_estimate(asm, bs) -> float:
    """max|eig| / min|eig| — the reference's gauge/conditioning analysis.

    Large systems stay matrix-free: LOBPCG gives the largest eigenvalue
    directly; the smallest comes from shift-invert, LOBPCG on lambda^-1
    (the reference's CSymEigsShiftSolver, Eigenvalues.h:378).  Pose-only
    systems apply lambda^-1 through one cached block Cholesky factor;
    systems with landmarks by block-Jacobi preconditioned CG."""
    n = asm.Np * asm.Bp + asm.Nl * asm.Bl
    if n <= _DENSE_LIMIT:
        w = np.linalg.eigvalsh(_dense_lambda(asm, bs))
        return float(np.abs(w).max() / max(np.abs(w).min(), 1e-300))
    w_hi, _ = sym_eigs(asm, bs, k=1, which="LM")
    hi = float(np.abs(w_hi[0]))

    Np, Bp = asm.Np, asm.Bp
    if asm.Nl == 0:
        # one MIS-Schur factorization, every LOBPCG iteration's columns
        # solved through it at once
        from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
        chol = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, Np, Bp, device=asm.device)
        f = chol.factor(bs.pp_blocks)

        def inv_op(X):
            m = X.shape[1]
            return chol.solve_with_factor(f, X.reshape(Np, Bp, m)).reshape(n, m)
    else:
        A, M = lambda_operator(asm, bs), _block_jacobi(asm, bs)

        def inv_op(X):
            return _pcg_columns(A, M, X, CG_TOL, min(4 * n, 20000))

    rng = np.random.default_rng(1)
    X0 = torch.as_tensor(rng.normal(0, 1, (n, 1)), dtype=bs.eta_p.dtype,
                         device=bs.eta_p.device)
    w_inv, _, _ = lobpcg_standard(inv_op, X0, m=25)
    lo = 1.0 / float(w_inv[0])
    return float(hi / max(abs(lo), 1e-300))
