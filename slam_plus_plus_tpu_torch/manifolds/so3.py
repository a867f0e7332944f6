"""SO(3): quaternion <-> axis-angle <-> rotation-matrix conversions, batched.

Port of slam_plus_plus_tpu/manifolds/so3.py; every function takes a leading
batch (``[..., 3]`` axis-angle, ``[..., 4]`` quaternions stored ``[w, x, y,
z]``).  Conventions kept from the JAX module:

  * axis-angle -> quat normalizes the sign so that ``w >= 0``;
  * quat -> axis-angle uses ``theta = 2 * atan2(|v|, w)`` on the ``w >= 0``
    representative, so recovered angles are in ``[-pi, pi]``;
  * small angles take the Taylor limit ``sin(x/2)/x -> 1/2`` branchlessly.
"""

from __future__ import annotations

import torch

_EPS2 = 1e-24  # squared-norm cutoff below which the Taylor limit is used


def _safe_norm(v):
    """Norm over the last axis, ~0 (not 0) below the cutoff; and the mask."""
    n2 = (v * v).sum(-1)
    small = n2 < _EPS2
    safe = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return torch.where(small, torch.full_like(n2, _EPS2 ** 0.5), safe), small


def axis_angle_to_quat(aa):
    """[..., 3] axis-angle -> [..., 4] quaternion (w >= 0)."""
    angle, small = _safe_norm(aa)
    half = angle * 0.5
    c = torch.cos(half)
    q = torch.where(small, torch.full_like(angle, 0.5), torch.sin(half) / angle)
    s = torch.where(c < 0, -torch.ones_like(c), torch.ones_like(c))
    quat = torch.cat([(c * s)[..., None], aa * (q * s)[..., None]], dim=-1)
    return quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)


def quat_to_axis_angle(q):
    """[..., 4] quaternion -> [..., 3] axis-angle with angle in [-pi, pi]."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., 0]
    v = q[..., 1:]
    vn, small = _safe_norm(v)
    angle = 2.0 * torch.atan2(vn, w)
    w_safe = torch.where(w < 1e-12, torch.ones_like(w), w)
    scale = torch.where(small, 2.0 / w_safe, angle / vn)
    return v * scale[..., None]


def quat_multiply(a, b):
    """Hamilton product a*b, both [..., 4] wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate [..., 3] vectors v by [..., 4] unit quaternions q."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_rotmat(q):
    """[..., 4] quaternion -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def axis_angle_to_rotmat(aa):
    return quat_to_rotmat(axis_angle_to_quat(aa))


def rotmat_to_quat(R):
    """[..., 3, 3] rotation matrix -> [..., 4] quaternion, w >= 0.

    Shepperd's method without branches, as the JAX module: the four
    candidate quaternions, each scaled by its (nonnegative) squared
    magnitude, and the one of the largest magnitude taken."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    zero = torch.zeros_like(r00)
    qw2 = torch.maximum(zero, 1.0 + r00 + r11 + r22) / 4.0
    qx2 = torch.maximum(zero, 1.0 + r00 - r11 - r22) / 4.0
    qy2 = torch.maximum(zero, 1.0 - r00 + r11 - r22) / 4.0
    qz2 = torch.maximum(zero, 1.0 - r00 - r11 + r22) / 4.0
    a, b = R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0]
    c = R[..., 1, 0] - R[..., 0, 1]
    d, e = R[..., 1, 0] + R[..., 0, 1], R[..., 0, 2] + R[..., 2, 0]
    f = R[..., 2, 1] + R[..., 1, 2]
    cands = torch.stack([
        torch.stack([qw2 * 4.0, a, b, c], dim=-1),
        torch.stack([a, qx2 * 4.0, d, e], dim=-1),
        torch.stack([b, d, qy2 * 4.0, f], dim=-1),
        torch.stack([c, e, f, qz2 * 4.0], dim=-1),
    ], dim=-2)                                                   # [..., 4, 4]
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def rotmat_to_axis_angle(R):
    """[..., 3, 3] rotation matrix -> [..., 3] axis-angle."""
    return quat_to_axis_angle(rotmat_to_quat(R))
