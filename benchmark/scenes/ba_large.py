"""Synthetic bundle-adjustment scene: cameras on a ring looking at a point
cloud, every point observed by the same number of cameras at fixed ring
offsets (a stride of n_cams // (3 k)), so the reduced camera system is
banded: each camera is covisible with 2 (k - 1) others.  Its counts may be
set to a published problem's; its sparsity pattern is the generator's.

A copy of the port's ``make_ba_scene_large`` and ``write_g2o_ba`` (same
seed, same cameras, points and observations), returning arrays instead of
lists and writing the file by whole columns.  The initial points are the
true points plus Gaussian noise drawn from the seed (``write_g2o_ba`` draws
them from a fixed seed of 1; ``noise_seed=1`` reproduces that).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.scenes import g2o


@dataclass
class BAScene:
    cam_pos: np.ndarray      # [C, 3] camera centres (world)
    cam_quat: np.ndarray     # [C, 4] world orientation, x y z w
    intrinsics: np.ndarray   # [C, 5] fx fy cx cy d
    points: np.ndarray       # [P, 3] true points
    points_init: np.ndarray  # [P, 3] initial estimate
    obs_point: np.ndarray    # [E] point index
    obs_cam: np.ndarray      # [E] camera index
    obs_uv: np.ndarray       # [E, 2] pixels

    @property
    def n_obs(self) -> int:
        return len(self.obs_point)

    def write(self, path: str) -> None:
        """VERTEX_CAM, VERTEX_XYZ and EDGE_PROJECT_P2MC lines; cameras take
        ids 0..C-1 and points C..C+P-1."""
        C, P = len(self.cam_pos), len(self.points)
        with open(path, "wb") as f:
            g2o.write_lines(f, "VERTEX_CAM", np.arange(C)[:, None],
                            np.concatenate([self.cam_pos, self.cam_quat, self.intrinsics], 1))
            g2o.write_lines(f, "VERTEX_XYZ", (C + np.arange(P))[:, None], self.points_init)
            g2o.write_lines(f, "EDGE_PROJECT_P2MC",
                            np.stack([C + self.obs_point, self.obs_cam], 1), self.obs_uv,
                            tail=" 1 0 1")

    def as_read(self) -> "BAScene":
        """The scene with every written value as a reader parses it."""
        return BAScene(g2o.as_read(self.cam_pos), g2o.as_read(self.cam_quat),
                       g2o.as_read(self.intrinsics), self.points,
                       g2o.as_read(self.points_init), self.obs_point, self.obs_cam,
                       g2o.as_read(self.obs_uv))


def _ring_cameras(n_cams: int):
    """(positions [C, 3], world rotations [C, 3, 3]) of cameras on a ring,
    each looking at the cloud's centre."""
    angs = 2 * np.pi * np.arange(n_cams) / n_cams
    pos = np.stack([3.0 * np.sin(angs), 0.5 * np.sin(2 * angs),
                    3.0 * np.cos(angs) - 0.5], axis=1)
    target = np.array([0.0, 0.0, 6.0])
    zaxis = target[None, :] - pos
    zaxis /= np.linalg.norm(zaxis, axis=1, keepdims=True)
    xaxis = np.cross(np.broadcast_to([0.0, 1.0, 0.0], zaxis.shape), zaxis)
    xaxis /= np.linalg.norm(xaxis, axis=1, keepdims=True)
    yaxis = np.cross(zaxis, xaxis)
    return pos, np.stack([xaxis, yaxis, zaxis], axis=2)


def _quat_xyzw(R: np.ndarray) -> np.ndarray:
    """[C, 4] quaternions of rotations R [C, 3, 3], as the generator takes
    them (w from the trace; the x-axis turn where w vanishes)."""
    qw = np.sqrt(np.maximum(0.0, 1 + np.trace(R, axis1=1, axis2=2))) / 2
    ok = qw > 1e-9
    d = np.where(ok, 4 * qw, 1.0)
    q = np.stack([(R[:, 2, 1] - R[:, 1, 2]) / d, (R[:, 0, 2] - R[:, 2, 0]) / d,
                  (R[:, 1, 0] - R[:, 0, 1]) / d, qw], axis=1)
    return np.where(ok[:, None], q, np.array([1.0, 0.0, 0.0, 0.0]))


def generate(params: dict, seed: int, noise_seed=None) -> BAScene:
    """The scene of params (n_cams, n_points, obs_per_point, noise_px,
    point_noise, f, cx, cy) for seed."""
    n_cams, n_points = int(params["n_cams"]), int(params["n_points"])
    k = int(params["obs_per_point"])
    f, cx, cy = float(params["f"]), float(params["cx"]), float(params["cy"])
    rng = np.random.default_rng(seed)
    points = rng.uniform(-2, 2, (n_points, 3))
    points[:, 2] += 6.0
    pos, R_wc = _ring_cameras(n_cams)
    # each point picks k cameras, spread with a random phase (nearby ring
    # indices see similar views)
    base = rng.integers(0, n_cams, n_points)
    stride = max(1, n_cams // (3 * k))
    cid = ((base[:, None] + stride * np.arange(k)[None, :]) % n_cams).reshape(-1)
    pid = np.repeat(np.arange(n_points), k)
    Rcw = np.swapaxes(R_wc, 1, 2)[cid]
    pc = np.einsum("eij,ej->ei", Rcw, points[pid] - pos[cid])
    pc[:, 2] = np.maximum(pc[:, 2], 0.5)
    noise = float(params["noise_px"])
    u = f * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, noise, len(pid))
    v = f * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, noise, len(pid))
    nrng = np.random.default_rng([seed, 1] if noise_seed is None else noise_seed)
    init = points + nrng.normal(0, float(params["point_noise"]), (n_points, 3))
    intr = np.tile([f, f, cx, cy, 0.0], (n_cams, 1))
    return BAScene(pos, _quat_xyzw(R_wc), intr, points, init, pid, cid, np.stack([u, v], 1))
