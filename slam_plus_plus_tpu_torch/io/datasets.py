"""Synthetic bundle-adjustment scene (port of the BA generator in
slam_plus_plus_tpu/io/datasets.py).

Pure numpy, seeded: the same arguments give the same file, byte for byte,
as the JAX package's generator.
"""

from __future__ import annotations

import numpy as np


def make_ba_scene(n_cams=20, n_points=500, noise_px=0.5, seed=0,
                  f=500.0, cx=320.0, cy=240.0):
    """Synthetic BA problem (venice analogue): cameras on a ring looking at a
    point cloud.  Returns (cam_params list, points [N,3], observations).

    cam_params: (position[3], quat_xyzw[4], fx, fy, cx, cy, d) — g2o
    VERTEX_CAM convention (world pose).
    observations: (point_id, cam_id, u, v).
    """
    rng = np.random.default_rng(seed)
    points = rng.uniform(-2, 2, (n_points, 3))
    points[:, 2] += 6.0

    cams = []
    obs = []
    for c in range(n_cams):
        ang = 2 * np.pi * c / n_cams
        pos = np.array([3.0 * np.sin(ang), 0.5 * np.sin(2 * ang),
                        3.0 * np.cos(ang) - 0.5])
        # camera looks at the cloud centroid
        target = np.array([0.0, 0.0, 6.0])
        zaxis = target - pos
        zaxis /= np.linalg.norm(zaxis)
        xaxis = np.cross(np.array([0.0, 1.0, 0.0]), zaxis)
        xaxis /= np.linalg.norm(xaxis)
        yaxis = np.cross(zaxis, xaxis)
        R_wc = np.stack([xaxis, yaxis, zaxis], axis=1)  # cam->world
        # quaternion of R_wc (world pose rotation)
        qw = np.sqrt(max(0.0, 1 + np.trace(R_wc))) / 2
        if qw > 1e-9:
            qx = (R_wc[2, 1] - R_wc[1, 2]) / (4 * qw)
            qy = (R_wc[0, 2] - R_wc[2, 0]) / (4 * qw)
            qz = (R_wc[1, 0] - R_wc[0, 1]) / (4 * qw)
        else:
            qx, qy, qz = 1.0, 0.0, 0.0
        cams.append((pos, np.array([qx, qy, qz, qw]), f, f, cx, cy, 0.0))

        Rcw = R_wc.T
        for pid in range(n_points):
            pc = Rcw @ (points[pid] - pos)
            if pc[2] < 0.5:
                continue
            u = f * pc[0] / pc[2] + cx
            v = f * pc[1] / pc[2] + cy
            if 0 <= u < 2 * cx and 0 <= v < 2 * cy and rng.random() < 0.6:
                obs.append((pid, c, u + rng.normal(0, noise_px),
                            v + rng.normal(0, noise_px)))
    return cams, points, obs


def write_g2o_ba(path, cams, points, obs, point_noise=0.05, seed=1):
    """Write VERTEX_CAM / VERTEX_XYZ / EDGE_PROJECT_P2MC file; landmark
    initializations are perturbed so there is something to optimize."""
    rng = np.random.default_rng(seed)
    n_cams = len(cams)
    with open(path, "w") as f:
        for c, (pos, q, fx, fy, cx, cy, d) in enumerate(cams):
            f.write(f"VERTEX_CAM {c} " +
                    " ".join(f"{v:.10f}" for v in pos) + " " +
                    " ".join(f"{v:.10f}" for v in q) +
                    f" {fx} {fy} {cx} {cy} {d}\n")
        for p, pt in enumerate(points):
            noisy = pt + rng.normal(0, point_noise, 3)
            f.write(f"VERTEX_XYZ {n_cams + p} " +
                    " ".join(f"{v:.10f}" for v in noisy) + "\n")
        for (pid, cid, u, v) in obs:
            f.write(f"EDGE_PROJECT_P2MC {n_cams + pid} {cid} {u:.10f} {v:.10f} "
                    f"1 0 1\n")
