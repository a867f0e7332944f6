"""SE(3) pose math, batched: state = [tx, ty, tz, ax, ay, az].

Port of slam_plus_plus_tpu/manifolds/se3.py (reference C3DJacobians,
include/slam/3DSolverBase.h:807-980): ``compose(p1, p2)`` is
t = t1 + R1 t2, q = q1 * q2, and the vertex ⊞ is right-composition.
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


def boxplus(x, dx):
    """Vertex retraction: right-compose with the delta (reference Operator_Plus)."""
    return compose(x, dx)
