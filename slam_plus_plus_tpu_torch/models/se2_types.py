"""SE(2) vertex/edge types (port of slam_plus_plus_tpu/models/se2_types.py,
reference include/slam/SE2_Types.h).

  * pose2d vertex: ⊞ = plain add + angle wrap (SE2_Types.h:70-75);
  * pose-pose edge: h = relative_to(x0, x1); r = z - h with wrapped angle
    (SE2_Types.h:305-320);
  * the pose-landmark edge is range-bearing: XY-parsed measurements are
    converted by ``xy_measurement_to_polar`` and their information set to
    identity (SE2_Types.h:602-615), as the reference does; RB-parsed
    measurements keep their information.

Residuals are batched over a leading axis; ``initializer`` is host numpy,
``device_initializer`` its torch counterpart for incremental activation.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.manifolds import se2
from slam_plus_plus_tpu_torch.models.types import edge_type, vertex_type


def _landmark_boxplus(x, dx):
    return x + dx


POSE2D = vertex_type("pose2d", 3, 3, se2.boxplus, schur_class="pose")
LANDMARK2D = vertex_type("landmark2d", 2, 2, _landmark_boxplus, schur_class="landmark")


def _pose2d_residual(states, z):
    x0, x1 = states
    r = z - se2.relative_to(x0, x1)
    return torch.cat([r[..., :2], se2.wrap_angle(r[..., 2:])], dim=-1)


def _pose2d_init(states, z):
    """Auto-create missing vertices at edge insertion (host numpy)."""
    x0, x1 = states
    if x0 is None:
        x0 = np.zeros(3)
    if x1 is None:
        c, s = np.cos(x0[2]), np.sin(x0[2])
        x1 = np.array([x0[0] + c * z[0] - s * z[1],
                       x0[1] + s * z[0] + c * z[1],
                       np.arctan2(np.sin(x0[2] + z[2]), np.cos(x0[2] + z[2]))])
    return x0, x1


def _pose2d_device_init(states, z, slot):
    """Activation: a new slot-1 pose composed from the other end; a new
    slot-0 pose at the origin."""
    if slot == 0:
        return torch.zeros_like(z)
    return se2.compose(states[0], z)


EDGE_POSE2D = edge_type("edge_pose2d", ("pose2d", "pose2d"), 3, 3,
                        _pose2d_residual, _pose2d_init,
                        device_initializer=_pose2d_device_init)


def _rb_residual(states, z):
    """Range-bearing observation of a 2D landmark (2DSolverBase.h:443+)."""
    pose, lm = states
    de = lm[..., 0] - pose[..., 0]
    dn = lm[..., 1] - pose[..., 1]
    rng = torch.clamp_min(torch.sqrt(de * de + dn * dn), 1e-5)  # reference |r| >= 1e-5
    brg = se2.wrap_angle(torch.atan2(dn, de) - pose[..., 2])
    return torch.stack([z[..., 0] - rng, se2.wrap_angle(z[..., 1] - brg)], dim=-1)


def _rb_init(states, z):
    pose, lm = states
    if pose is None:
        pose = np.zeros(3)
    if lm is None:
        # z is [range, bearing]: landmark at pose ∘ polar offset
        ang = pose[2] + z[1]
        lm = np.array([pose[0] + z[0] * np.cos(ang), pose[1] + z[0] * np.sin(ang)])
    return pose, lm


def _rb_device_init(states, z, slot):
    if slot == 0:
        return torch.zeros(z.shape[:-1] + (3,), dtype=z.dtype, device=z.device)
    pose = states[0]
    ang = pose[..., 2] + z[..., 1]
    return torch.stack([pose[..., 0] + z[..., 0] * torch.cos(ang),
                        pose[..., 1] + z[..., 0] * torch.sin(ang)], dim=-1)


EDGE_POSE_LANDMARK2D = edge_type("edge_pose_landmark2d", ("pose2d", "landmark2d"),
                                 2, 2, _rb_residual, _rb_init,
                                 device_initializer=_rb_device_init)


def xy_measurement_to_polar(xy: np.ndarray):
    """v_ToPolar: XY landmark offset -> [range, bearing]; the information
    becomes identity (reference t_ToPolar)."""
    rng = float(np.hypot(xy[0], xy[1]))
    brg = float(np.arctan2(xy[1], xy[0]))
    return np.array([rng, brg]), np.eye(2)
