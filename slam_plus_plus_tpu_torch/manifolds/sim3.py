"""Sim(3) similarity-transform math, batched: state = [t(3), axis-angle(3), scale(1)].

Port of slam_plus_plus_tpu/manifolds/sim3.py (reference
CSim3Jacobians::TSim3, include/slam/Sim3SolverBase.h:88-230): the "tRs"
storage is translation + axis-angle + linear scale; composition is
``t = t1 + s1 R1 t2, R = R1 R2, s = s1 s2``; inversion is
``s' = 1/s, R' = R^T, t' = -s' R' t``.  The vertex ⊞ composes with the
*exponential* of a 7D sim(3) tangent vector ``[u(3), w(3), lambda(1)]``.

Every function takes a leading batch (``[..., 7]`` states) and goes through
``torch.func`` transforms: the small-angle and small-scale limits of
``_w_matrix`` are branchless, with every denominator made safe in both
branches (the double ``where``), so forward-mode Jacobians at δ = 0 are
finite.  The thresholds are the JAX module's: 1e-9 on θ² and on |λ|.
"""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.manifolds import so3

_EPS = 1e-9


def compose(a, b):
    qa = so3.axis_angle_to_quat(a[..., 3:6])
    qb = so3.axis_angle_to_quat(b[..., 3:6])
    t = a[..., :3] + a[..., 6:7] * so3.quat_rotate(qa, b[..., :3])
    aa = so3.quat_to_axis_angle(so3.quat_multiply(qa, qb))
    return torch.cat([t, aa, a[..., 6:7] * b[..., 6:7]], dim=-1)


def inverse(p):
    qi = so3.quat_conjugate(so3.axis_angle_to_quat(p[..., 3:6]))
    s_inv = 1.0 / p[..., 6:7]
    t = -s_inv * so3.quat_rotate(qi, p[..., :3])
    return torch.cat([t, so3.quat_to_axis_angle(qi), s_inv], dim=-1)


def relative_to(a, b):
    """b expressed in the frame of a: a^-1 * b."""
    return compose(inverse(a), b)


def _skew(w):
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _w_matrix(w, lam):
    """W = integral_0^1 e^(lam*tau) exp(tau [w]_x) dtau, closed form
    (w [..., 3], lam [...] -> [..., 3, 3]).

    Expanding the rotation exponential, W = A I + B [w]_x + C [w]_x^2 with
        A = int e^(lt) dt            = (s - 1)/l
        B = int e^(lt) sin(t h)/h dt = (a l + h (1 - b)) / (h (l^2 + h^2))
        C = int e^(lt)(1-cos(t h))/h^2 dt = (A - ((b - 1) l + a h)/(l^2+h^2)) / h^2
    where h = |w|, s = e^l, a = s sin h, b = s cos h.  Small-h / small-l use
    the Taylor limits of the defining integrals (branchless).
    """
    one = torch.ones_like(lam)
    theta2 = (w * w).sum(-1)
    small_th = theta2 < _EPS
    theta = torch.sqrt(torch.where(small_th, one, theta2))
    s = torch.exp(lam)
    small_lam = torch.abs(lam) < _EPS
    lam_safe = torch.where(small_lam, one, lam)

    A = torch.where(small_lam, 1.0 + lam / 2.0 + lam * lam / 6.0, (s - 1.0) / lam_safe)

    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + lam * lam
    c_safe = torch.where(c < _EPS, one, c)

    B_full = (a * lam + theta * (1.0 - b)) / (torch.where(small_th, one, theta) * c_safe)
    C_full = (A - ((b - 1.0) * lam + a * theta) / c_safe) / torch.where(small_th, one, theta2)

    # theta -> 0 limits: B -> int e^(lt) t dt, C -> int e^(lt) t^2/2 dt
    lam3_safe = lam_safe * lam_safe * lam_safe
    B_small = torch.where(small_lam, 0.5 + lam / 3.0,
                          (s * (lam - 1.0) + 1.0) / (lam_safe * lam_safe))
    C_small = torch.where(small_lam, 1.0 / 6.0 + lam / 8.0,
                          (s * (lam * lam - 2.0 * lam + 2.0) - 2.0) / (2.0 * lam3_safe))

    B = torch.where(small_th, B_small, B_full)
    C = torch.where(small_th, C_small, C_full)

    wx = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (A[..., None, None] * eye + B[..., None, None] * wx +
            C[..., None, None] * (wx @ wx))


def exp(tangent):
    """sim(3) exponential: [..., 7] [u(3), w(3), lambda(1)] -> [t, aa, s]."""
    u, w, lam = tangent[..., :3], tangent[..., 3:6], tangent[..., 6]
    t = (_w_matrix(w, lam) @ u[..., None])[..., 0]
    return torch.cat([t, w, torch.exp(lam)[..., None]], dim=-1)


def log(p):
    """Inverse of exp: [..., 7] [t, aa, s] -> [u, w, lambda].  Solves W u = t."""
    w = p[..., 3:6]
    lam = torch.log(p[..., 6])
    u = torch.linalg.solve(_w_matrix(w, lam), p[..., :3])
    return torch.cat([u, w, lam[..., None]], dim=-1)


def boxplus(x, dx):
    """Vertex retraction: x ∘ Exp(dx) (reference CVertexSim3::Operator_Plus
    composes with an exp of the tangent delta)."""
    return compose(x, exp(dx))


def transform_point(p, x):
    """Apply the similarity transform: s R x + t (p [..., 7], x [..., 3])."""
    q = so3.axis_angle_to_quat(p[..., 3:6])
    return p[..., 6:7] * so3.quat_rotate(q, x) + p[..., :3]
