"""Radial distortion model matching the optimizer's projection.

Port of slam_plus_plus_tpu/geometry/distortion.py, host numpy as there.

Reference analogue: include/geometry/DistortionModel.h and the projection in
BASolverBase.h — pixel-space radial distortion w = 1 + k r^2 with
k = d / mean_focal (the parse-time scaling of Changelog.txt:44-46).
"""

from __future__ import annotations

import numpy as np


def distort(uv, intrinsics):
    """Apply pixel-space radial distortion; uv [..,2], intrinsics [5]
    (fx fy cx cy d_scaled)."""
    fx, fy, cx, cy, d = intrinsics
    k = d / (0.5 * (fx + fy))
    du = uv[..., 0] - cx
    dv = uv[..., 1] - cy
    w = 1.0 + k * (du * du + dv * dv)
    return np.stack([cx + w * du, cy + w * dv], axis=-1)


def undistort(uv, intrinsics, iters: int = 8):
    """Invert the distortion by fixed-point iteration."""
    fx, fy, cx, cy, d = intrinsics
    k = d / (0.5 * (fx + fy))
    du = uv[..., 0] - cx
    dv = uv[..., 1] - cy
    du_u, dv_u = du.copy(), dv.copy()
    for _ in range(iters):
        w = 1.0 + k * (du_u * du_u + dv_u * dv_u)
        du_u = du / w
        dv_u = dv / w
    return np.stack([cx + du_u, cy + dv_u], axis=-1)
