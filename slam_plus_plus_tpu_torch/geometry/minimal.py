"""Minimal geometric solvers: P3P, essential matrix, homography.

Reference analogue: the standalone geometry module (reference
include/geometry/P3P.h, TwoView.h:51, Homography.h, Polynomial.h) — minimal
solvers used for initialization/data association outside the main optimizer.
Port of slam_plus_plus_tpu/geometry/minimal.py, host numpy as there: these
run on tiny fixed-size problems during front-end processing.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


# ----------------------------------------------------------------------
# P3P (Grunert's classic formulation via the quartic resolvent)
# ----------------------------------------------------------------------

def p3p(bearings: np.ndarray, points: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Pose from 3 world points and their unit bearing vectors.

    bearings: [3,3] unit vectors in the camera frame; points: [3,3] world.
    Returns a list of (R, t) with x_cam = R @ x_world + t (up to 4 solutions).
    Reference analogue: include/geometry/P3P.h."""
    f1, f2, f3 = (bearings[i] / np.linalg.norm(bearings[i]) for i in range(3))
    P1, P2, P3 = points

    # pairwise angles and squared distances
    c12 = float(f1 @ f2)
    c13 = float(f1 @ f3)
    c23 = float(f2 @ f3)
    d12 = float(np.sum((P1 - P2) ** 2))
    d13 = float(np.sum((P1 - P3) ** 2))
    d23 = float(np.sum((P2 - P3) ** 2))
    if min(d12, d13, d23) < 1e-24:
        return []

    # Grunert elimination with s2 = u s1, s3 = v s1:
    #   C1: s1^2 (1 + u^2 - 2 u c12)      = d12
    #   C2: s1^2 (1 + v^2 - 2 v c13)      = d13
    #   C3: s1^2 (u^2 + v^2 - 2 u v c23)  = d23
    # C1/C2 gives  u^2 - 2 c12 u - A(v) = 0,
    #   A(v) = (1 + v^2 - 2 v c13) d12/d13 - 1          (quadratic in v)
    # C3/C2 with the substitution isolates u rationally: u = N(v)/D(v),
    #   N(v) = (d23/d13)(1 + v^2 - 2 v c13) - A(v) - v^2 (quadratic)
    #   D(v) = 2 (c12 - v c23)                           (linear)
    # substituting back clears to the classic quartic:
    #   N^2 - 2 c12 N D - A D^2 = 0.
    r12 = d12 / d13
    r23 = d23 / d13
    # polynomials in v, highest degree first
    base = np.array([1.0, -2.0 * c13, 1.0])          # 1 + v^2 - 2 v c13
    A = r12 * base - np.array([0.0, 0.0, 1.0])       # quadratic
    Nv = r23 * base - A - np.array([1.0, 0.0, 0.0])  # quadratic
    Dv = np.array([-2.0 * c23, 2.0 * c12])           # linear
    quartic = np.polysub(
        np.polysub(np.polymul(Nv, Nv), 2.0 * c12 * np.polymul(Nv, Dv)),
        np.polymul(A, np.polymul(Dv, Dv)))

    roots = np.roots(quartic)
    sols = []
    for v in roots:
        if abs(v.imag) > 1e-8 or v.real <= 0:
            continue
        v = float(v.real)
        s1_sq = d13 / (1.0 + v * v - 2.0 * v * c13)
        if s1_sq <= 0:
            continue
        s1 = np.sqrt(s1_sq)
        Dval = 2.0 * (c12 - v * c23)
        if abs(Dval) < 1e-12:
            continue
        u = float(np.polyval(Nv, v)) / Dval
        if u <= 0:
            continue
        pc = np.stack([s1 * f1, (u * s1) * f2, (v * s1) * f3])
        R, t = _procrustes_rt(points, pc)
        sols.append((R, t))
    return sols


def _procrustes_rt(src: np.ndarray, dst: np.ndarray):
    """Rigid R, t with dst = R @ src + t (Kabsch)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


# ----------------------------------------------------------------------
# essential matrix (normalized 8-point) + decomposition
# ----------------------------------------------------------------------

def essential_8pt(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """E from >= 8 normalized image correspondences (x2^T E x1 = 0).

    x1, x2: [N, 2] normalized coordinates.  Reference analogue: the
    five-point/essential machinery of include/geometry/TwoView.h (the
    8-point path; the 5-point minimal variant shares the decomposition)."""
    N = len(x1)
    A = np.zeros((N, 9))
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A[:, 0] = u2 * u1
    A[:, 1] = u2 * v1
    A[:, 2] = u2
    A[:, 3] = v2 * u1
    A[:, 4] = v2 * v1
    A[:, 5] = v2
    A[:, 6] = u1
    A[:, 7] = v1
    A[:, 8] = 1.0
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    # project to the essential manifold (two equal singular values)
    U, S, Vt = np.linalg.svd(E)
    s = (S[0] + S[1]) / 2
    E = U @ np.diag([s, s, 0.0]) @ Vt
    return E


def essential_5pt(x1: np.ndarray, x2: np.ndarray) -> List[np.ndarray]:
    """Minimal five-point essential solver (Stewenius action-matrix /
    Grobner-basis method).

    Reference analogue: CFivePoint_EssentialSolver_Grobner
    (reference include/geometry/TwoView.h:44-125).  x1, x2: [5+, 2]
    normalized correspondences (x2^T E x1 = 0; extra rows join the null
    space least-squares like the reference's overdetermined variant,
    TwoView.h:87-106).  Returns up to 10 real essential matrices.

    Method: the 4-dim null space of the epipolar design matrix gives
    E = x X + y Y + z Z + W; det(E) = 0 and the trace constraint
    2 E E^T E - tr(E E^T) E = 0 yield 10 cubics in (x, y, z).  Reducing
    their 10x20 coefficient matrix to [I | A] over the 10 degree-3 leading
    monomials leaves the quotient-ring basis {x^2, xy, xz, y^2, yz, z^2,
    x, y, z, 1}; the eigenvectors of the multiply-by-x action matrix
    evaluate the basis at each solution."""
    N = len(x1)
    A = np.zeros((N, 9))
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A[:, 0] = u2 * u1
    A[:, 1] = u2 * v1
    A[:, 2] = u2
    A[:, 3] = v2 * u1
    A[:, 4] = v2 * v1
    A[:, 5] = v2
    A[:, 6] = u1
    A[:, 7] = v1
    A[:, 8] = 1.0
    _, _, Vt = np.linalg.svd(A)
    basis = Vt[-4:][::-1]                      # X, Y, Z, W rows
    X, Y, Z, W = (b.reshape(3, 3) for b in basis)

    # polynomial arithmetic over monomials (i, j, k) = x^i y^j z^k
    def pmul(p, q):
        out = {}
        for ma, ca in p.items():
            for mb, cb in q.items():
                key = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
                out[key] = out.get(key, 0.0) + ca * cb
        return out

    def padd(*ps):
        out = {}
        for p in ps:
            for m, c in p.items():
                out[m] = out.get(m, 0.0) + c
        return out

    def pscale(p, s):
        return {m: c * s for m, c in p.items()}

    # E entries as degree-1 polynomials
    Ep = [[{(1, 0, 0): X[r, c], (0, 1, 0): Y[r, c],
            (0, 0, 1): Z[r, c], (0, 0, 0): W[r, c]}
           for c in range(3)] for r in range(3)]

    def mat_mul(Ap, Bp):
        return [[padd(*[pmul(Ap[r][k], Bp[k][c]) for k in range(3)])
                 for c in range(3)] for r in range(3)]

    def mat_T(Ap):
        return [[Ap[c][r] for c in range(3)] for r in range(3)]

    EEt = mat_mul(Ep, mat_T(Ep))
    trace = padd(EEt[0][0], EEt[1][1], EEt[2][2])
    EEtE = mat_mul(EEt, Ep)
    eqs = []
    for r in range(3):
        for c in range(3):
            eqs.append(padd(pscale(EEtE[r][c], 2.0),
                            pscale(pmul(trace, Ep[r][c]), -1.0)))
    # det(E)
    det = padd(
        pmul(Ep[0][0], padd(pmul(Ep[1][1], Ep[2][2]),
                            pscale(pmul(Ep[1][2], Ep[2][1]), -1.0))),
        pscale(pmul(Ep[0][1], padd(pmul(Ep[1][0], Ep[2][2]),
                                   pscale(pmul(Ep[1][2], Ep[2][0]), -1.0))),
               -1.0),
        pmul(Ep[0][2], padd(pmul(Ep[1][0], Ep[2][1]),
                            pscale(pmul(Ep[1][1], Ep[2][0]), -1.0))))
    eqs.append(det)

    # 10x20 coefficient matrix: leading = degree-3 monomials, trailing =
    # the quotient basis (degree <= 2)
    lead = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
            (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
    quot = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
            (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    cols = lead + quot
    cidx = {m: i for i, m in enumerate(cols)}
    M = np.zeros((10, 20))
    for i, eq in enumerate(eqs):
        for m, c in eq.items():
            M[i, cidx[m]] = c
    try:
        Ared = np.linalg.solve(M[:, :10], M[:, 10:])   # [I | Ared]
    except np.linalg.LinAlgError:
        return []

    # action matrix of multiplication by x on the quotient basis
    T = np.zeros((10, 10))
    qidx = {m: i for i, m in enumerate(quot)}
    for j, m in enumerate(quot):
        xm = (m[0] + 1, m[1], m[2])
        if xm in qidx:
            T[qidx[xm], j] = 1.0
        else:
            li = lead.index(xm)
            T[:, j] = -Ared[li]
    # x * b_j = sum_m T[m, j] b_m  =>  the basis-evaluation vector b is an
    # eigenvector of T^T with eigenvalue x
    w, V = np.linalg.eig(T.T)
    out = []
    for i in range(10):
        if abs(w[i].imag) > 1e-6 * (1 + abs(w[i].real)):
            continue
        v = V[:, i].real
        if abs(v[9]) < 1e-12:
            continue
        x, y, z = v[6] / v[9], v[7] / v[9], v[8] / v[9]
        E = x * X + y * Y + z * Z + W
        n = np.linalg.norm(E)
        if np.isfinite(n) and n > 1e-12:
            out.append(E / n)
    return out


def decompose_essential(E: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """(R, t) with cheirality disambiguation from correspondences."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = [(U @ W @ Vt, U[:, 2]), (U @ W @ Vt, -U[:, 2]),
             (U @ W.T @ Vt, U[:, 2]), (U @ W.T @ Vt, -U[:, 2])]
    best, best_n = None, -1
    from slam_plus_plus_tpu_torch.geometry.triangulate import triangulate_two_view
    for R, t in cands:
        X = triangulate_two_view(np.eye(3), np.zeros(3), R, t, x1, x2)
        z1 = X[:, 2]
        z2 = (X @ R.T + t)[:, 2]
        n_front = int(np.sum((z1 > 0) & (z2 > 0)))
        if n_front > best_n:
            best, best_n = (R, t), n_front
    return best


# ----------------------------------------------------------------------
# homography (DLT)
# ----------------------------------------------------------------------

def homography_dlt(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """H with x2 ~ H x1 from >= 4 correspondences ([N,2] each).

    Reference analogue: include/geometry/Homography.h."""
    N = len(x1)
    A = np.zeros((2 * N, 9))
    for i in range(N):
        X, Y = x1[i]
        u, v = x2[i]
        A[2 * i] = [-X, -Y, -1, 0, 0, 0, u * X, u * Y, u]
        A[2 * i + 1] = [0, 0, 0, -X, -Y, -1, v * X, v * Y, v]
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]
