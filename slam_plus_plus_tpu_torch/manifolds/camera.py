"""Camera projection models for bundle adjustment, batched.

Port of slam_plus_plus_tpu/manifolds/camera.py (reference
CBAJacobians::Project_P2C, include/slam/BASolverBase.h:260-330): the camera
stores the world-to-camera transform ``x_cam = R X + t``; intrinsics are
``[fx, fy, cx, cy, d]`` with ``k = d / (0.5 (fx + fy))``; radial distortion
acts on pixel coordinates about the principal point.  Every function takes
a leading batch (``[..., d]``).
"""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.manifolds import so3


def _to_cam(cam, point):
    """World point -> camera frame: R(cam) point + t(cam)."""
    R = so3.axis_angle_to_rotmat(cam[..., 3:6])
    return (R @ point[..., None])[..., 0] + cam[..., :3]


def project_p2c(cam, intrinsics, point):
    """cam [..., 6], intrinsics [..., 5], point [..., 3] -> pixels [..., 2]."""
    fx, fy, cx, cy, d = intrinsics.unbind(-1)
    k = d / (0.5 * (fx + fy))
    x = _to_cam(cam, point)
    inv_z = 1.0 / x[..., 2]
    u = fx * x[..., 0] * inv_z + cx
    v = fy * x[..., 1] * inv_z + cy
    du, dv = u - cx, v - cy
    r2 = du * du + dv * dv
    w = 1.0 + k * r2
    return torch.stack([cx + w * du, cy + w * dv], dim=-1)


def project_p2sc(cam, intrinsics, point):
    """Stereo projection -> [..., 3] = [u, v, u - f b / z] (reference
    Project_P2SC).  intrinsics [..., 5] = fx fy cx cy baseline: no radial
    distortion here (the stereo edge type applies its own)."""
    fx, fy, cx, cy, b = intrinsics.unbind(-1)
    x = _to_cam(cam, point)
    inv_z = 1.0 / x[..., 2]
    u = fx * x[..., 0] * inv_z + cx
    v = fy * x[..., 1] * inv_z + cy
    u_right = fx * (x[..., 0] - b) * inv_z + cx
    return torch.stack([u, v, u_right], dim=-1)


def project_spheron(cam, point):
    """Spherical projection: the [..., 3] unit bearing of the point in the
    camera frame (reference Project_P2S)."""
    x = _to_cam(cam, point)
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n < 1e-12, torch.ones_like(n), n)


def world_pose_to_cam(position, quat_xyzw, invert: bool = True):
    """g2o VERTEX_CAM world pose (position [..., 3], xyzw quaternion
    [..., 4]) -> the internal world-to-camera [..., 6] = [t, axis-angle]."""
    q = torch.cat([quat_xyzw[..., 3:4], quat_xyzw[..., :3]], dim=-1)   # -> wxyz
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    if invert:
        qi = so3.quat_conjugate(q)
        t = -so3.quat_rotate(qi, position)
        return torch.cat([t, so3.quat_to_axis_angle(qi)], dim=-1)
    return torch.cat([position, so3.quat_to_axis_angle(q)], dim=-1)


def cam_to_world_pose(cam):
    """Inverse of world_pose_to_cam: [..., 6] -> (position [..., 3],
    quat_xyzw [..., 4])."""
    qi = so3.quat_conjugate(so3.axis_angle_to_quat(cam[..., 3:6]))
    pos = -so3.quat_rotate(qi, cam[..., :3])
    return pos, torch.cat([qi[..., 1:], qi[..., :1]], dim=-1)
