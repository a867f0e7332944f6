"""SE(2) pose math, batched: state = [x, y, theta].

Port of slam_plus_plus_tpu/manifolds/se2.py (reference C2DJacobians,
include/slam/2DSolverBase.h:44-443): composition rotates the child
translation by the parent heading and adds angles; every produced angle is
wrapped into [-pi, pi]; the vertex ⊞ is plain addition with an angle wrap
(reference include/slam/SE2_Types.h:70-75).  Every function takes a leading
batch (``[..., 3]`` poses, ``[..., 2]`` landmarks) and has no data-dependent
Python branch, so ``torch.func.vmap`` and ``jacfwd`` go through it.
"""

from __future__ import annotations

import torch


def wrap_angle(a):
    """Wrap angle into [-pi, pi] (reference f_ClampAngle_2Pi)."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def compose(p1, p2):
    """relative_to_absolute: pose p2 expressed relative to p1 -> absolute."""
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    return torch.stack([
        p1[..., 0] + c * p2[..., 0] - s * p2[..., 1],
        p1[..., 1] + s * p2[..., 0] + c * p2[..., 1],
        wrap_angle(p1[..., 2] + p2[..., 2]),
    ], dim=-1)


def relative_to(p1, p2):
    """absolute_to_relative: pose p2 in the frame of p1."""
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    dx, dy = p2[..., 0] - p1[..., 0], p2[..., 1] - p1[..., 1]
    return torch.stack([
        c * dx + s * dy,
        -s * dx + c * dy,
        wrap_angle(p2[..., 2] - p1[..., 2]),
    ], dim=-1)


def inverse(p):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    return torch.stack([-(c * p[..., 0] + s * p[..., 1]),
                        -(-s * p[..., 0] + c * p[..., 1]),
                        -p[..., 2]], dim=-1)


def boxplus(x, dx):
    """Vertex retraction: plain addition + angle wrap."""
    out = x + dx
    return torch.cat([out[..., :2], wrap_angle(out[..., 2:])], dim=-1)


def landmark_in_frame(pose, lm):
    """[..., 2] landmark world position expressed in the pose frame."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    dx, dy = lm[..., 0] - pose[..., 0], lm[..., 1] - pose[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)
