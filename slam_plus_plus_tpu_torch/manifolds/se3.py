"""SE(3) pose math, batched: state = [tx, ty, tz, ax, ay, az].

Port of slam_plus_plus_tpu/manifolds/se3.py (reference C3DJacobians,
include/slam/3DSolverBase.h:807-980):

  * ``compose(p1, p2)``: t = t1 + R1 t2, q = q1 * q2;
  * ``relative_to(p1, p2)``: t = R1^-1 (t2 - t1), q = q1^-1 * q2;
  * the pose-graph edge error uses plain translation subtraction and the
    quaternion error ``log(q_z * q_h^-1)`` (reference
    include/slam/SE3_Types.h:265-290);
  * the vertex ⊞ is right-composition (reference Operator_Plus).

Every function takes a leading batch and goes through ``torch.func``
transforms (the so3 helpers use the double-``where`` safe norm).
"""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.manifolds import so3


def compose(p1, p2):
    q1 = so3.axis_angle_to_quat(p1[..., 3:])
    q2 = so3.axis_angle_to_quat(p2[..., 3:])
    t = p1[..., :3] + so3.quat_rotate(q1, p2[..., :3])
    aa = so3.quat_to_axis_angle(so3.quat_multiply(q1, q2))
    return torch.cat([t, aa], dim=-1)


def relative_to(p1, p2):
    q1i = so3.quat_conjugate(so3.axis_angle_to_quat(p1[..., 3:]))
    q2 = so3.axis_angle_to_quat(p2[..., 3:])
    t = so3.quat_rotate(q1i, p2[..., :3] - p1[..., :3])
    aa = so3.quat_to_axis_angle(so3.quat_multiply(q1i, q2))
    return torch.cat([t, aa], dim=-1)


def inverse(p):
    qi = so3.quat_conjugate(so3.axis_angle_to_quat(p[..., 3:]))
    t = -so3.quat_rotate(qi, p[..., :3])
    return torch.cat([t, so3.quat_to_axis_angle(qi)], dim=-1)


def boxplus(x, dx):
    """Vertex retraction: right-compose with the delta (reference Operator_Plus)."""
    return compose(x, dx)


def pose_error(z, h):
    """Edge error convention: [z_t - h_t, log(q_z q_h^-1)]."""
    qz = so3.axis_angle_to_quat(z[..., 3:])
    qh = so3.axis_angle_to_quat(h[..., 3:])
    aa = so3.quat_to_axis_angle(so3.quat_multiply(qz, so3.quat_conjugate(qh)))
    return torch.cat([z[..., :3] - h[..., :3], aa], dim=-1)


def landmark_in_frame(pose, lm):
    """[..., 3] world landmark expressed in the pose frame (R^-1 (l - t))."""
    q = so3.axis_angle_to_quat(pose[..., 3:])
    return so3.quat_rotate(so3.quat_conjugate(q), lm - pose[..., :3])
