"""Manhattan-world 2D pose graph (Olson's M3500 class): a grid random walk,
noisy odometry and loop closures between poses that lie close.

``faithful`` is a copy of the port's ``make_manhattan_2d`` and
``write_g2o_2d`` (same seed, same poses and edges; the edges in
chronological order, sorted by their larger vertex id), returning arrays.
``generate`` takes that walk and draws exactly ``closures`` loop closures,
uniformly among every pair of poses that lie within ``loop_radius`` and
more than five steps apart, so that a pose may close several loops, as in
Olson's graph; the walk and the closures come from ``structure_seed``, the
measurement noise from the run's seed.  The walk draws from one random
stream in a data-dependent order, so it stays a loop over poses, well under
a second at 3,500 poses.  The file holds the EDGE2 lines alone, as Olson's
file does: the CLI's parser initialises SE(2) vertices from the edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.scenes import g2o


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def _rel(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], _wrap(b[2] - a[2])])


@dataclass
class PoseScene:
    poses: np.ndarray      # [N, 3] ground truth (not written)
    edge_i: np.ndarray     # [K] in file order
    edge_j: np.ndarray     # [K]
    z: np.ndarray          # [K, 3]
    info: np.ndarray       # [K, 3, 3]

    @property
    def n_poses(self) -> int:
        return len(self.poses)

    @property
    def n_edges(self) -> int:
        return len(self.edge_i)

    def write(self, path: str) -> None:
        iu = np.triu_indices(3)
        with open(path, "wb") as f:
            g2o.write_lines(f, "EDGE2", np.stack([self.edge_i, self.edge_j], 1),
                            np.concatenate([self.z, self.info[:, iu[0], iu[1]]], 1))

    def as_read(self) -> "PoseScene":
        return PoseScene(self.poses, self.edge_i, self.edge_j, g2o.as_read(self.z),
                         g2o.as_read(self.info))

    def prefix(self, n_poses: int) -> "PoseScene":
        """The stream's first n_poses poses and every edge among them."""
        keep = np.maximum(self.edge_i, self.edge_j) < n_poses
        return PoseScene(self.poses[:n_poses], self.edge_i[keep], self.edge_j[keep],
                         self.z[keep], self.info[keep])


def generate(params: dict, seed: int) -> PoseScene:
    """The scene of params for seed: the walk of ``structure_seed``, its
    odometry and exactly ``closures`` loop closures drawn from the same
    seed, every measurement's noise drawn anew from seed.  Every seed so
    gives the same graph, the same solve points and sizes, and other
    measurements."""
    n, structure = int(params["n_poses"]), int(params["structure_seed"])
    poses = walk(n, float(params["step"]), np.random.default_rng(structure))
    # every pair (i, j), i more than five steps before j, within the radius
    radius2 = float(params["loop_radius"]) ** 2
    ci, cj = [], []
    for j0 in range(0, n, 512):
        d2 = np.sum((poses[j0:j0 + 512, None, :2] - poses[None, :, :2]) ** 2, axis=-1)
        jj, ii = np.nonzero((d2 < radius2)
                            & (np.arange(n)[None, :] < np.arange(j0, j0 + len(d2))[:, None] - 5))
        ci.append(ii)
        cj.append(jj + j0)
    ci, cj = np.concatenate(ci), np.concatenate(cj)
    k = int(params["closures"])
    if k > len(ci):
        raise ValueError(f"{k} closures asked, {len(ci)} pairs within the radius")
    pick = np.sort(np.random.default_rng([structure, 1]).choice(len(ci), k, replace=False))
    ei = np.concatenate([np.arange(n - 1), ci[pick]])
    ej = np.concatenate([np.arange(1, n), cj[pick]])
    # chronological: by the newer pose, its odometry first, closures by the older pose
    order = np.lexsort((ei, ej))
    ei, ej = ei[order], ej[order]
    tn, rn = float(params["trans_noise"]), float(params["rot_noise"])
    rng = np.random.default_rng(seed)
    a, b = poses[ei], poses[ej]
    c, sn = np.cos(a[:, 2]), np.sin(a[:, 2])
    d = b[:, :2] - a[:, :2]
    m = len(ei)
    z = np.stack([c * d[:, 0] + sn * d[:, 1] + rng.normal(0, tn, m),
                  -sn * d[:, 0] + c * d[:, 1] + rng.normal(0, tn, m),
                  _wrap(_wrap(b[:, 2] - a[:, 2]) + rng.normal(0, rn, m))], 1)
    info = np.diag([1.0 / tn ** 2, 1.0 / tn ** 2, 1.0 / rn ** 2])
    return PoseScene(poses, ei, ej, z, np.broadcast_to(info, (m, 3, 3)).copy())


def walk(n: int, step: float, rng) -> np.ndarray:
    """[n, 3] poses of the grid walk: a quarter turn left or right with
    probability 1/4 before each step; the first draws of rng."""
    poses = np.zeros((n, 3))
    heading = 0.0
    pos = np.zeros(2)
    for i in range(1, n):
        if rng.random() < 0.25:
            heading = _wrap(heading + rng.choice([-1, 1]) * np.pi / 2)
        pos = pos + step * np.array([np.cos(heading), np.sin(heading)])
        poses[i] = [pos[0], pos[1], heading]
    return poses


def faithful(params: dict, seed: int) -> PoseScene:
    """The port's ``make_manhattan_2d`` with params (n_poses, step,
    trans_noise, rot_noise, loop_prob, loop_radius) and seed, its edges in
    ``write_g2o_2d``'s order."""
    n = int(params["n_poses"])
    step = float(params["step"])
    tn, rn = float(params["trans_noise"]), float(params["rot_noise"])
    loop_prob, radius = float(params["loop_prob"]), float(params["loop_radius"])
    rng = np.random.default_rng(seed)
    poses = walk(n, step, rng)
    info = np.diag([1.0 / tn ** 2, 1.0 / tn ** 2, 1.0 / rn ** 2])
    ii, jj, zs = [], [], []
    for i in range(n - 1):
        z = _rel(poses[i], poses[i + 1])
        z[:2] += rng.normal(0, tn, 2)
        z[2] = _wrap(z[2] + rng.normal(0, rn))
        ii.append(i)
        jj.append(i + 1)
        zs.append(z)
    for j in range(10, n):
        if rng.random() >= loop_prob:
            continue
        d2 = np.sum((poses[:j - 5, :2] - poses[j, :2]) ** 2, axis=1)
        i = int(np.argmin(d2))
        if d2[i] < radius ** 2:
            z = _rel(poses[i], poses[j])
            z[:2] += rng.normal(0, tn, 2)
            z[2] = _wrap(z[2] + rng.normal(0, rn))
            ii.append(i)
            jj.append(j)
            zs.append(z)
    ei, ej = np.asarray(ii, dtype=np.int64), np.asarray(jj, dtype=np.int64)
    order = np.argsort(np.maximum(ei, ej), kind="stable")
    z = np.asarray(zs)[order]
    return PoseScene(poses, ei[order], ej[order], z, np.broadcast_to(info, (len(z), 3, 3)).copy())
