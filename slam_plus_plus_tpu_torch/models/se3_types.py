"""SE(3) vertex/edge types (port of slam_plus_plus_tpu/models/se3_types.py,
reference include/slam/SE3_Types.h).

  * pose3d vertex state [t, axis-angle], ⊞ = right-compose (SE3_Types.h:46);
  * pose-pose edge: h = relative_to(x0, x1); error translation z_t - h_t,
    rotation log(q_z q_h^-1) (SE3_Types.h:265-290); robust (Huber, scale
    0.3, SE3_Types.h:128-129) and differentiated through h (expectation
    mode), as the reference;
  * the ternary pose hyperedge (reference CEdgePose3D_Ternary,
    SE3_Types.h:339): z observes the SE(3) increment between the relative
    motions 0->1 and 1->2;
  * pose-landmark edge: h = landmark in the pose frame; r = z - h
    (SE3_Types.h:569+).

Residuals are batched over a leading axis; ``initializer`` is host numpy,
``device_initializer`` its torch counterpart for incremental activation.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.manifolds import se3, so3
from slam_plus_plus_tpu_torch.models.types import edge_type, vertex_type


def _landmark_boxplus(x, dx):
    return x + dx


POSE3D = vertex_type("pose3d", 6, 6, se3.boxplus, schur_class="pose")
LANDMARK3D = vertex_type("landmark3d", 3, 3, _landmark_boxplus, schur_class="landmark")


# ---- host numpy SE(3) helpers for vertex initialization ------------------

def _np_aa2q(aa):
    a = np.linalg.norm(aa)
    if a < 1e-12:
        q = np.array([1.0, aa[0] * 0.5, aa[1] * 0.5, aa[2] * 0.5])
        return q / np.linalg.norm(q)
    c, s = np.cos(a * 0.5), np.sin(a * 0.5) / a
    if c < 0:
        c, s = -c, -s
    return np.array([c, aa[0] * s, aa[1] * s, aa[2] * s])


def _np_q2aa(q):
    w, v = q[0], q[1:]
    if w < 0:
        w, v = -w, -v
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.zeros(3)
    return v * (2.0 * np.arctan2(n, w) / n)


def _np_qrot(q, p):
    u, w = q[1:], q[0]
    uv = np.cross(u, p)
    return p + 2.0 * (w * uv + np.cross(u, uv))


def _np_qmul(a, b):
    return np.array([
        a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3],
        a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2],
        a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1],
        a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0],
    ])


def _np_se3_compose(p1, p2):
    q1 = _np_aa2q(np.asarray(p1[3:], float))
    q2 = _np_aa2q(np.asarray(p2[3:], float))
    t = np.asarray(p1[:3], float) + _np_qrot(q1, np.asarray(p2[:3], float))
    return np.concatenate([t, _np_q2aa(_np_qmul(q1, q2))])


def _np_se3_relative(p1, p2):
    """p2 in p1's frame (mirrors se3.relative_to)."""
    q1 = _np_aa2q(np.asarray(p1[3:], float))
    q1c = np.array([q1[0], -q1[1], -q1[2], -q1[3]])
    t = _np_qrot(q1c, np.asarray(p2[:3], float) - np.asarray(p1[:3], float))
    q2 = _np_aa2q(np.asarray(p2[3:], float))
    return np.concatenate([t, _np_q2aa(_np_qmul(q1c, q2))])


# ---- pose-pose edge --------------------------------------------------------

def _pose3d_expectation(states):
    x0, x1 = states
    return se3.relative_to(x0, x1)


def _pose3d_residual(states, z):
    return se3.pose_error(z, _pose3d_expectation(states))


def _pose3d_init(states, z):
    x0, x1 = states
    if x0 is None:
        x0 = np.zeros(6)
    if x1 is None:
        x1 = _np_se3_compose(np.asarray(x0, float), np.asarray(z, float))
    return x0, x1


def _origin(z, dim):
    return torch.zeros(z.shape[:-1] + (dim,), dtype=z.dtype, device=z.device)


def _pose3d_device_init(states, z, slot):
    if slot == 0:
        return _origin(z, 6)
    return se3.compose(states[0], z)


EDGE_POSE3D = edge_type("edge_pose3d", ("pose3d", "pose3d"), 6, 6,
                        _pose3d_residual, _pose3d_init, robust=True,
                        expectation=_pose3d_expectation, error=se3.pose_error,
                        device_initializer=_pose3d_device_init)


# ---- ternary pose hyperedge ------------------------------------------------

def _pose3d_ternary_expectation(states):
    x0, x1, x2 = states
    return se3.relative_to(se3.relative_to(x0, x1), se3.relative_to(x1, x2))


def _pose3d_ternary_residual(states, z):
    return se3.pose_error(z, _pose3d_ternary_expectation(states))


def _pose3d_ternary_init(states, z):
    x0, x1, x2 = states
    if x0 is None:
        x0 = np.zeros(6)
    if x1 is None:
        x1 = np.asarray(x0, float).copy()
    if x2 is None:
        m01 = _np_se3_relative(np.asarray(x0, float), np.asarray(x1, float))
        x2 = _np_se3_compose(np.asarray(x1, float),
                             _np_se3_compose(m01, np.asarray(z, float)))
    return x0, x1, x2


def _pose3d_ternary_device_init(states, z, slot):
    if slot == 0:
        return _origin(z, 6)
    if slot == 1:
        return states[0]
    m01 = se3.relative_to(states[0], states[1])
    return se3.compose(states[1], se3.compose(m01, z))


EDGE_POSE3D_TERNARY = edge_type(
    "edge_pose3d_ternary", ("pose3d", "pose3d", "pose3d"), 6, 6,
    _pose3d_ternary_residual, _pose3d_ternary_init,
    expectation=_pose3d_ternary_expectation, error=se3.pose_error,
    device_initializer=_pose3d_ternary_device_init)


# ---- pose-landmark edge ----------------------------------------------------

def _lm3d_residual(states, z):
    pose, lm = states
    return z - se3.landmark_in_frame(pose, lm)


def _lm3d_init(states, z):
    pose, lm = states
    if pose is None:
        pose = np.zeros(6)
    if lm is None:
        q = _np_aa2q(np.asarray(pose[3:], float))
        lm = _np_qrot(q, np.asarray(z, float)) + pose[:3]
    return pose, lm


def _lm3d_device_init(states, z, slot):
    if slot == 0:
        return _origin(z, 6)
    pose = states[0]
    return so3.quat_rotate(so3.axis_angle_to_quat(pose[..., 3:]), z) + pose[..., :3]


EDGE_POSE_LANDMARK3D = edge_type("edge_pose_landmark3d", ("pose3d", "landmark3d"),
                                 3, 3, _lm3d_residual, _lm3d_init,
                                 device_initializer=_lm3d_device_init)
