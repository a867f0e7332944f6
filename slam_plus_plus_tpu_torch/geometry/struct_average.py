"""Rigid 3D structure averaging from repeated observations.

Port of slam_plus_plus_tpu/geometry/struct_average.py (reference
include/geometry/StructAverage.h CAverage_RigidStructure::Calculate: each
observation of an n-point rigid structure is Kabsch-aligned to the first
observation and the aligned point clouds are averaged, then re-centered).

All observations align in one batched pass on the observations' device: a
batched 3x3 ``torch.linalg.svd`` and ``det`` over ``[n_obs, 3, 3]`` (the
JAX package's vmapped Kabsch).
"""

from __future__ import annotations

import numpy as np
import torch


def _kabsch_rt(src, dst):
    """Rigid transforms (R [..., 3, 3], t [..., 3]) minimizing
    ||R src + t - dst|| per batch of [..., n, 3] clouds (the reference's
    CAttitudeEstimator_Kabsch role, include/geometry/Kabsch.h)."""
    c_s = src.mean(dim=-2)
    c_d = dst.mean(dim=-2)
    H = (src - c_s[..., None, :]).mT @ (dst - c_d[..., None, :])
    U, _s, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.mT @ U.mT)
    S = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    R = Vt.mT @ S @ U.mT
    t = c_d - (R @ c_s[..., None])[..., 0]
    return R, t


def average_structure(observations):
    """observations: [n_obs, n_points, 3] repeated observations of a rigid
    structure (first observation is the alignment anchor; a numpy array
    becomes a float64 tensor on the host).  Returns the centered average
    structure [n_points, 3] on the observations' device."""
    obs = (observations if torch.is_tensor(observations)
           else torch.as_tensor(np.asarray(observations, dtype=np.float64)))
    R, t = _kabsch_rt(obs, obs[0].expand_as(obs))
    aligned = obs @ R.mT + t[:, None, :]
    avg = aligned.mean(dim=0)
    return avg - avg.mean(dim=0)


def average_structure_np(flat_points: np.ndarray, n_structure: int, *, device="cuda"):
    """Reference-interface variant: a flat [N, 3] array holding N/n
    complete observations back to back (CAverage_RigidStructure::Calculate,
    StructAverage.h:62-112), averaged in float64 on ``device``; returns
    numpy."""
    pts = np.asarray(flat_points, dtype=np.float64)
    n_obs = len(pts) // n_structure
    obs = pts[:n_obs * n_structure].reshape(n_obs, n_structure, 3)
    return average_structure(torch.as_tensor(obs, device=device)).cpu().numpy()
