"""Reusable polynomial module: closed-form low-order root solvers, a
general companion-matrix solver, and robust least-squares polynomial
fitting.

Port of slam_plus_plus_tpu/geometry/polynomial.py (reference
include/geometry/PolySolve.h: CQuadraticEq:219, CCubicEq:419,
CQuarticEq:646 — closed-form solvers with the depressed-form / resolvent
decompositions; include/geometry/Polynomial.h: least-squares polynomial
fitting with optional robust score functions / IRLS, :543-1168).

The closed-form solvers are batched torch over a leading axis, on the
device of the tensors they are given (numpy inputs become float64 tensors
on the host), with the JAX package's NaN padding and root counts.  torch
has no cube root: ``cbrt`` is sign(x) |x|^(1/3).  The general solver uses
the companion-matrix eigenvalues on host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.robust.losses import LOSSES

_EPS = 1e-30


def _tensors(*xs):
    """The arguments as tensors broadcast to one shape (``_as_like``)."""
    return torch.broadcast_tensors(*_as_like(*xs))


def cbrt(x):
    """Real cube root, sign(x) |x|^(1/3) (odd, and 0 at 0)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def quadratic_roots(a, b, c):
    """Real roots of a x^2 + b x + c, batched over leading dims.

    Returns (roots [..., 2], count [...]): roots sorted ascending, invalid
    lanes hold NaN.  Degenerate a==0 falls back to the linear root
    (reference CQuadraticEq handles the same degeneracies, PolySolve.h:219).
    Uses the numerically stable q-formula (no cancellation)."""
    a, b, c = _tensors(a, b, c)
    lin = torch.abs(a) < _EPS
    disc = b * b - 4.0 * a * c
    has2 = (disc >= 0) & ~lin
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q = -0.5 * (b + torch.sign(b + (b == 0).to(b.dtype)) * sq)
    r1 = q / torch.where(torch.abs(a) < _EPS, 1.0, a)
    r2 = c / torch.where(torch.abs(q) < _EPS, 1.0, q)
    lo = torch.minimum(r1, r2)
    hi = torch.maximum(r1, r2)
    lroot = -c / torch.where(lin, torch.where(torch.abs(b) < _EPS, 1.0, b), 1.0)
    nan = torch.full_like(lo, float("nan"))
    roots = torch.stack(
        [torch.where(lin, torch.where(torch.abs(b) < _EPS, nan, lroot),
                     torch.where(has2, lo, nan)),
         torch.where(lin, nan, torch.where(has2, hi, nan))], dim=-1)
    count = torch.where(lin, (torch.abs(b) >= _EPS).to(torch.int32),
                        2 * has2.to(torch.int32))
    return roots, count


def cubic_roots(a, b, c, d):
    """Real roots of a x^3 + ... + d (a != 0), batched; trigonometric /
    Cardano closed form on the depressed cubic (reference CCubicEq,
    PolySolve.h:419).  Returns (roots [..., 3], count [...]) with NaN
    padding; roots unsorted (first lane always valid)."""
    a, b, c, d = _tensors(a, b, c, d)
    inv_a = 1.0 / a
    B, C, D = b * inv_a, c * inv_a, d * inv_a
    off = B / 3.0
    p = C - B * B / 3.0
    q = 2.0 * B ** 3 / 27.0 - B * C / 3.0 + D
    disc = (q * q) / 4.0 + (p ** 3) / 27.0

    # one real root (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    u = cbrt(-q / 2.0 + sq)
    v = cbrt(-q / 2.0 - sq)
    r_single = u + v - off

    # three real roots (disc <= 0): trigonometric
    pm = torch.clamp_max(p, -_EPS)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    th = torch.arccos(arg) / 3.0
    k = torch.arange(3, dtype=a.dtype, device=a.device)
    tri = (m[..., None] * torch.cos(th[..., None] - 2.0 * torch.pi * k / 3.0)
           - off[..., None])

    three = disc <= 0
    nan = r_single * float("nan")
    roots = torch.stack(
        [torch.where(three, tri[..., 0], r_single),
         torch.where(three, tri[..., 1], nan),
         torch.where(three, tri[..., 2], nan)], dim=-1)
    count = torch.where(three, 3, 1).to(torch.int32)
    return roots, count


def quartic_roots(a, b, c, d, e):
    """Real roots of the quartic via the resolvent-cubic / two-quadratics
    decomposition of the depressed form (reference CQuarticEq,
    PolySolve.h:646-780).  Batched; returns (roots [..., 4], count)."""
    a, b, c, d, e = _tensors(a, b, c, d, e)
    inv_a = 1.0 / a
    B, C, D, E = b * inv_a, c * inv_a, d * inv_a, e * inv_a
    off = B / 4.0
    # depressed: u^4 + alpha u^2 + beta u + gamma
    alpha = C - 3.0 * B * B / 8.0
    beta = D - B * C / 2.0 + B ** 3 / 8.0
    gamma = E - 3.0 * B ** 4 / 256.0 + B * B * C / 16.0 - B * D / 4.0

    # resolvent cubic: y^3 + (5a/2) y^2 + (2a^2-g) y + (a^3/2 - ag/2 - b^2/8)
    ry, _cnt = cubic_roots(torch.ones_like(alpha), 2.5 * alpha,
                           2.0 * alpha * alpha - gamma,
                           0.5 * alpha ** 3 - 0.5 * alpha * gamma
                           - beta * beta / 8.0)
    y = ry[..., 0]
    w2 = alpha + 2.0 * y
    w = torch.sqrt(torch.clamp_min(w2, 0.0))
    ok_w = w2 > _EPS
    t = torch.where(ok_w, beta / (2.0 * torch.where(ok_w, w, 1.0)), 0.0)
    # u^2 +- w u + (alpha + y -+ t) = 0
    r12, _ = quadratic_roots(torch.ones_like(w), w, alpha + y - t)
    r34, _ = quadratic_roots(torch.ones_like(w), -w, alpha + y + t)
    roots = torch.cat([r12, r34], dim=-1) - off[..., None]
    count = torch.isfinite(roots).sum(-1).to(torch.int32)
    return roots, count


def polish_roots(coeffs, roots, iters: int = 2):
    """Newton-polish roots of polynomial sum_k coeffs[..., k] x^(n-k)
    (highest power first) — the reference polishes its closed-form roots
    the same way (PolySolve.h f_ImproveRoot)."""
    x, coeffs = _as_like(roots, coeffs)
    n = coeffs.shape[-1] - 1
    for _ in range(iters):
        f = torch.zeros_like(x)
        df = torch.zeros_like(x)
        for k in range(n + 1):
            ck = coeffs[..., k][..., None]
            f = f * x + ck
            if k < n:
                df = df * x + ck * (n - k)
        x = x - torch.where(torch.abs(df) > _EPS, f / df, 0.0)
    return x


def roots_companion(coeffs: np.ndarray) -> np.ndarray:
    """All (complex) roots of one polynomial via companion-matrix
    eigenvalues on host (LAPACK) — the general fallback for degree > 4."""
    c = np.asarray(coeffs, dtype=np.float64)
    c = np.trim_zeros(c, "f")
    if len(c) <= 1:
        return np.zeros(0, dtype=np.complex128)
    return np.roots(c)


#: polyfit_robust's reweighting passes (the JAX default)
IRLS_ITERS = 5


def polyfit_robust(x, y, degree: int, loss: str | None = None,
                   scale: float = 1.0):
    """Least-squares polynomial fit with optional robust IRLS reweighting.

    The reference's Polynomial.h fitter role: normal equations over the
    Vandermonde basis (its CPolynomial::LeastSquares_Fit, Polynomial.h:543)
    with score-function reweighting (:791-951), IRLS_ITERS passes.  loss
    names index robust.losses.LOSSES.  Returns coeffs highest-power-first
    [degree+1] on the device of x and y."""
    x, y = _as_like(x, y)
    V = torch.stack([x ** k for k in range(degree, -1, -1)], dim=-1)

    def wls(w):
        Vw = V * w[:, None]
        A = Vw.T @ V
        rhs = Vw.T @ y
        return torch.linalg.solve(A + 1e-12 * torch.eye(degree + 1, dtype=x.dtype,
                                                        device=x.device), rhs)

    w = torch.ones_like(y)
    coef = wls(w)
    if loss is not None:
        lf = LOSSES[loss]
        for _ in range(IRLS_ITERS):
            r = V @ coef - y
            w = lf(torch.abs(r) / scale)
            coef = wls(w)
    return coef


def _as_like(*xs):
    """Each argument as a tensor (no broadcasting) on the device and in the
    floating dtype of the first tensor among them, float64 on the host
    when none is a tensor."""
    like = next((x for x in xs if torch.is_tensor(x)), None)
    dev = like.device if like is not None else torch.device("cpu")
    dt = like.dtype if like is not None and like.is_floating_point() else torch.float64
    return tuple(torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=dt,
                                 device=dev) for x in xs)
