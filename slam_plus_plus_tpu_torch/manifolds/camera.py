"""Mono camera projection for bundle adjustment, batched.

Port of slam_plus_plus_tpu/manifolds/camera.py::project_p2c (reference
CBAJacobians::Project_P2C, include/slam/BASolverBase.h:260-330): the camera
stores the world-to-camera transform ``x_cam = R X + t``; intrinsics are
``[fx, fy, cx, cy, d]`` with ``k = d / (0.5 (fx + fy))``; radial distortion
acts on pixel coordinates about the principal point.
"""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.manifolds import so3


def project_p2c(cam, intrinsics, point):
    """cam [..., 6], intrinsics [..., 5], point [..., 3] -> pixels [..., 2]."""
    fx, fy, cx, cy, d = intrinsics.unbind(-1)
    k = d / (0.5 * (fx + fy))
    R = so3.axis_angle_to_rotmat(cam[..., 3:6])
    x = (R @ point[..., None])[..., 0] + cam[..., :3]
    inv_z = 1.0 / x[..., 2]
    u = fx * x[..., 0] * inv_z + cx
    v = fy * x[..., 1] * inv_z + cy
    du, dv = u - cx, v - cy
    r2 = du * du + dv * dv
    w = 1.0 + k * r2
    return torch.stack([cx + w * du, cy + w * dv], dim=-1)
