"""Bundle-adjustment types (port of slam_plus_plus_tpu/models/ba_types.py,
reference include/slam/BA_Types.h).

  * the cam vertex stores 11 floats: [t(3), axis-angle(3) world->cam, fx, fy,
    cx, cy, d'] with d' = d * mean focal (parse-time scaling); only the first
    6 are optimized (tangent 6), ⊞ = SE3 right-compose;
  * the scam (stereo) vertex stores 12: pose(6) + [fx fy cx cy d' baseline];
  * the spheron vertex is an SE(3) pose (6/6), the intrinsics vertex
    [fx fy cx cy d'] (5/5, additive ⊞); all three are pose class;
  * the P2C residual is r = z - project (BA_Types.h:92-103), P2CI the same
    with the intrinsics taken from their own vertex; the stereo residual is
    [u_l, v_l, u_r] with the distortion factor 1 + k r, where mono has
    1 + k r^2 — the reference's asymmetry (Project_P2C vs Project_P2SC),
    kept as the JAX package keeps it; the spheron residual is the landmark
    in the camera frame.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.manifolds import camera, se3, so3
from slam_plus_plus_tpu_torch.models.types import edge_type, vertex_type


def _cam_boxplus(x, dx):
    """SE3 right-compose on the pose part; intrinsics stay constant."""
    return torch.cat([se3.boxplus(x[..., :6], dx), x[..., 6:]], dim=-1)


def _xyz_boxplus(x, dx):
    """Additive ⊞ (points, intrinsics)."""
    return x + dx


CAM = vertex_type("cam", 11, 6, _cam_boxplus, schur_class="pose")
SCAM = vertex_type("scam", 12, 6, _cam_boxplus, schur_class="pose")
SPHERON = vertex_type("spheron", 6, 6, se3.boxplus, schur_class="pose")
INTRINSICS = vertex_type("intrinsics", 5, 5, _xyz_boxplus, schur_class="pose")
XYZ = vertex_type("xyz", 3, 3, _xyz_boxplus, schur_class="landmark")


def _p2c_residual(states, z):
    cam_state, point = states
    h = camera.project_p2c(cam_state[..., :6], cam_state[..., 6:11], point)
    return z - h


def _np_aa2q(aa):
    a = np.linalg.norm(aa)
    if a < 1e-12:
        q = np.array([1.0, aa[0] * 0.5, aa[1] * 0.5, aa[2] * 0.5])
        return q / np.linalg.norm(q)
    c, s = np.cos(a * 0.5), np.sin(a * 0.5) / a
    if c < 0:
        c, s = -c, -s
    return np.array([c, aa[0] * s, aa[1] * s, aa[2] * s])


def _np_qrot(q, p):
    u, w = q[1:], q[0]
    uv = np.cross(u, p)
    return p + 2.0 * (w * uv + np.cross(u, uv))


def _p2c_init(states, z):
    """Host initializer for vertices an edge references before they exist:
    a missing point goes on the optical axis at unit depth."""
    cam_state, point = states
    if cam_state is None:
        cam_state = np.zeros(11)
    if point is None:
        q = _np_aa2q(np.asarray(cam_state[3:6], float))
        qi = np.concatenate([q[:1], -q[1:]])
        point = _np_qrot(qi, np.array([0.0, 0.0, 1.0]) -
                         np.asarray(cam_state[:3], float))
    return cam_state, point


EDGE_P2C = edge_type("edge_p2c", ("cam", "xyz"), 2, 2, _p2c_residual, _p2c_init)


def _p2ci_residual(states, z):
    cam_state, point, intr = states
    return z - camera.project_p2c(cam_state[..., :6], intr, point)


EDGE_P2CI = edge_type("edge_p2ci", ("cam", "xyz", "intrinsics"), 2, 2, _p2ci_residual)


def _p2sc_residual(states, z):
    cam_state, point = states
    fx, fy, cx, cy, d, b = cam_state[..., 6:12].unbind(-1)
    k = d / (0.5 * (fx + fy))
    R = so3.axis_angle_to_rotmat(cam_state[..., 3:6])
    t = cam_state[..., :3]

    def distort_uv(x):
        inv_z = 1.0 / x[..., 2]
        u = fx * x[..., 0] * inv_z + cx
        v = fy * x[..., 1] * inv_z + cy
        du, dv = u - cx, v - cy
        w = 1.0 + k * torch.sqrt(du * du + dv * dv)  # stereo: linear in r
        return cx + w * du, cy + w * dv

    def to_cam(p):
        return (R @ p[..., None])[..., 0] + t

    u_l, v_l = distort_uv(to_cam(point))
    # right camera: the world point shifted by -b along the camera x-axis
    u_r, _ = distort_uv(to_cam(point - b[..., None] * R[..., 0, :]))
    return z - torch.stack([u_l, v_l, u_r], dim=-1)


EDGE_P2SC = edge_type("edge_p2sc", ("scam", "xyz"), 3, 3, _p2sc_residual)


def _spheron_residual(states, z):
    pose, point = states
    return z - se3.landmark_in_frame(pose, point)


def _spheron_init(states, z):
    """Spheron files carry no VERTEX_XYZ (it would make the dataset peek as
    mono BA): a point is created from its first observation, world =
    R(pose) z + t."""
    pose, point = states
    if pose is None:
        pose = np.zeros(6)
    if point is None:
        q = _np_aa2q(np.asarray(pose[3:6], float))
        point = _np_qrot(q, np.asarray(z, float)) + pose[:3]
    return pose, point


EDGE_SPHERON_XYZ = edge_type("edge_spheron_xyz", ("spheron", "xyz"), 3, 3,
                             _spheron_residual, _spheron_init)
