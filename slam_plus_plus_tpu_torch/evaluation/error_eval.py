"""Trajectory quality evaluation: ATE / RPE with Kabsch alignment.

Port of slam_plus_plus_tpu/evaluation/error_eval.py (numpy, as there).
Reference analogue: CErrorEvaluation (reference include/slam/ErrorEval.h:40,
Compute_AbsoluteTrajectoryError / Compute_RelativePoseError at :138-240) —
cumulative, per-vertex, and RMSE absolute trajectory errors plus relative
pose errors, with rigid Kabsch alignment of the estimate onto the ground
truth.  Host-side numpy: evaluation is an offline analysis step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def kabsch_align(src: np.ndarray, dst: np.ndarray,
                 with_scale: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (optionally similarity) alignment src -> dst.

    src, dst: [N, d] point sets (d = 2 or 3).
    Returns (R [d,d], t [d], s) with  dst ~ s * R @ src + t.
    Reference analogue: the Kabsch alignment inside ErrorEval.h
    (v_Align_PoseSets)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    X = src - mu_s
    Y = dst - mu_d
    H = X.T @ Y
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.eye(H.shape[0])
    D[-1, -1] = d
    R = Vt.T @ D @ U.T
    if with_scale:
        var = (X * X).sum()
        s = float((S * np.diag(D)).sum() / var) if var > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def _positions(poses: np.ndarray) -> np.ndarray:
    """[N, 3] (2D: x,y,theta) or [N, 6] (3D: t, axis-angle) -> positions."""
    poses = np.asarray(poses)
    d = 2 if poses.shape[1] == 3 else 3
    return poses[:, :d]


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE over positions, after alignment."""
    p_est = _positions(est)
    p_gt = _positions(gt)
    if align:
        R, t, s = kabsch_align(p_est, p_gt, with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def _rel_2d(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    th = np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], th])


def _aa_to_R(aa):
    th = np.linalg.norm(aa)
    if th < 1e-12:
        return np.eye(3)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _R_to_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def rpe_errors(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """Relative pose errors over pairs (i, i+delta).

    Returns (trans_errors [M], rot_errors [M]) — rotation in radians."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    n = len(est)
    te, re = [], []
    is2d = est.shape[1] == 3
    for i in range(n - delta):
        j = i + delta
        if is2d:
            de = _rel_2d(est[i], est[j])
            dg = _rel_2d(gt[i], gt[j])
            te.append(np.linalg.norm(de[:2] - dg[:2]))
            re.append(abs(np.arctan2(np.sin(de[2] - dg[2]),
                                     np.cos(de[2] - dg[2]))))
        else:
            Re = _aa_to_R(est[i][3:]).T @ _aa_to_R(est[j][3:])
            Rg = _aa_to_R(gt[i][3:]).T @ _aa_to_R(gt[j][3:])
            pe = _aa_to_R(est[i][3:]).T @ (est[j][:3] - est[i][:3])
            pg = _aa_to_R(gt[i][3:]).T @ (gt[j][:3] - gt[i][:3])
            te.append(np.linalg.norm(pe - pg))
            re.append(_R_to_angle(Re.T @ Rg))
    return np.asarray(te), np.asarray(re)


def evaluate_trajectory(est: np.ndarray, gt: np.ndarray,
                        delta: int = 1) -> dict:
    """Summary dict: ATE RMSE, RPE trans/rot RMSE — the headline metrics the
    reference prints for ground-truth comparisons."""
    te, re = rpe_errors(est, gt, delta)
    return {
        "ate_rmse": ate_rmse(est, gt),
        "rpe_trans_rmse": float(np.sqrt((te ** 2).mean())) if len(te) else 0.0,
        "rpe_rot_rmse": float(np.sqrt((re ** 2).mean())) if len(re) else 0.0,
    }
