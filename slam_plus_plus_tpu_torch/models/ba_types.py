"""Mono bundle-adjustment types (port of slam_plus_plus_tpu/models/ba_types.py,
reference include/slam/BA_Types.h).

  * the cam vertex stores 11 floats: [t(3), axis-angle(3) world->cam, fx, fy,
    cx, cy, d'] with d' = d * mean focal (parse-time scaling); only the first
    6 are optimized (tangent 6), ⊞ = SE3 right-compose;
  * the P2C residual is r = z - project (BA_Types.h:92-103).

The stereo, intrinsics and spheron types are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.manifolds import camera, se3
from slam_plus_plus_tpu_torch.models.types import edge_type, vertex_type


def _cam_boxplus(x, dx):
    """SE3 right-compose on the pose part; intrinsics stay constant."""
    return torch.cat([se3.boxplus(x[..., :6], dx), x[..., 6:]], dim=-1)


def _xyz_boxplus(x, dx):
    return x + dx


CAM = vertex_type("cam", 11, 6, _cam_boxplus, schur_class="pose")
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
