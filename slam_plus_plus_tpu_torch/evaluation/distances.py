"""Compact-pose distances under the posterior (marginals-driven).

Port of slam_plus_plus_tpu/evaluation/distances.py (reference
include/slam/Distances.h, the IJRR compact-pose-SLAM distance machinery):
the distribution of the relative pose between two vertices under the
current posterior, from their marginal covariances, and the transform
that reduces it to 4D [x, y, z, angle] for the data-association test,
CSE3_XYZ_RotationMagnitude_DistanceTransform (:79): angle = |axis-angle| of
the relative rotation.  (The view-direction transform, :145, waits for a
caller: ROADMAP.md.)

Host-side, as in the JAX package: numpy in and out, float64 on the CPU, the
Jacobians by ``torch.func`` forward mode through the port's SE(3) math.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slam_plus_plus_tpu_torch.manifolds import se3


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def relative_pose_distribution(x_i, x_j, sigma_ii, sigma_jj,
                               sigma_ij=None) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of the SE(3) relative pose d = x_i^-1 x_j.

    sigma_*: [6, 6] marginal covariance blocks in the vertices' tangent
    spaces; sigma_ij the cross-covariance (None = 0, the block-diagonal
    approximation the reference takes when only the diagonal is kept)."""
    x_i, x_j = _t(x_i), _t(x_j)
    mean = se3.relative_to(x_i, x_j).numpy()
    zero = torch.zeros(6, dtype=torch.float64)
    J_i = torch.func.jacfwd(lambda d: se3.relative_to(se3.boxplus(x_i, d), x_j))(zero).numpy()
    J_j = torch.func.jacfwd(lambda d: se3.relative_to(x_i, se3.boxplus(x_j, d)))(zero).numpy()
    sigma = J_i @ np.asarray(sigma_ii) @ J_i.T + J_j @ np.asarray(sigma_jj) @ J_j.T
    if sigma_ij is not None:
        c = J_i @ np.asarray(sigma_ij) @ J_j.T
        sigma = sigma + c + c.T
    return mean, sigma


def rotation_magnitude_transform(mean, sigma):
    """[x y z aa] 6D distribution -> 4D [x y z theta] (reference :79-140)."""
    mean = np.asarray(mean, float)
    sigma = np.asarray(sigma, float)
    H = np.zeros((4, 6))
    H[:3, :3] = np.eye(3)
    aa = mean[3:]
    D = np.linalg.norm(aa)
    H[3, 3:] = aa / D if D > 0 else 1.0 / np.sqrt(3.0)
    return np.concatenate([mean[:3], [D]]), H @ sigma @ H.T


def mahalanobis_distance2(mean4, sigma4) -> float:
    """Squared Mahalanobis distance of the zero-relative-pose hypothesis."""
    d = np.asarray(mean4, float)
    try:
        return float(d @ np.linalg.solve(np.asarray(sigma4, float), d))
    except np.linalg.LinAlgError:
        return float("inf")


def mahalanobis_gate(mean4, sigma4, threshold4) -> bool:
    """The data-association test: is the zero-distance hypothesis within
    the gate, |d|_Sigma^2 <= |threshold4|^2?  (The compact-pose SLAM
    association test.)"""
    d = np.asarray(mean4, float)
    try:
        m2 = float(d @ np.linalg.solve(sigma4, d))
    except np.linalg.LinAlgError:
        return False
    thr = np.asarray(threshold4, float)
    return m2 <= float(thr @ thr)
