"""Point triangulation.

Port of slam_plus_plus_tpu/geometry/triangulate.py (reference
include/geometry/Triangulate.h — DLT two-view and N-view linear
triangulation), host numpy as there: one small SVD per point.
"""

from __future__ import annotations

import numpy as np


def triangulate_two_view(R1, t1, R2, t2, x1, x2) -> np.ndarray:
    """DLT triangulation of [N,2] normalized correspondences.

    Camera model: x ~ [R | t] X (normalized coordinates).
    Returns [N, 3] world points (in the frame of camera parameters given)."""
    P1 = np.concatenate([R1, np.asarray(t1).reshape(3, 1)], axis=1)
    P2 = np.concatenate([R2, np.asarray(t2).reshape(3, 1)], axis=1)
    X = np.zeros((len(x1), 3))
    for i in range(len(x1)):
        A = np.stack([
            x1[i, 0] * P1[2] - P1[0],
            x1[i, 1] * P1[2] - P1[1],
            x2[i, 0] * P2[2] - P2[0],
            x2[i, 1] * P2[2] - P2[1],
        ])
        _, _, Vt = np.linalg.svd(A)
        h = Vt[-1]
        X[i] = h[:3] / h[3]
    return X


def triangulate_nview(Rs, ts, xs) -> np.ndarray:
    """N-view DLT for a single point: Rs [V,3,3], ts [V,3], xs [V,2]."""
    rows = []
    for v in range(len(Rs)):
        P = np.concatenate([Rs[v], np.asarray(ts[v]).reshape(3, 1)], axis=1)
        rows.append(xs[v][0] * P[2] - P[0])
        rows.append(xs[v][1] * P[2] - P[1])
    A = np.stack(rows)
    _, _, Vt = np.linalg.svd(A)
    h = Vt[-1]
    return h[:3] / h[3]
