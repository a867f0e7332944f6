"""Victoria Park class landmark SLAM (Guivant & Nebot's park, as SLAM++'s
``victoria-park.txt``): a vehicle's odometry chain and range-bearing
sightings of the trees beside its track, with no pose-pose loop closure,
so that every loop closes through a tree seen again.

``generate`` takes the Manhattan walk of ``structure_seed``
(``manhattan_2d.walk``) as the trajectory and places ``n_landmarks`` trees,
each at a uniform offset within ``radius`` of a pose drawn from the walk
(drawn again until at least two poses see it).  Of the (pose, tree) pairs
within ``radius``, each tree gets two observations first, and the rest of
the ``observations`` are drawn uniformly from the other pairs.  The walk,
the trees and which pairs are observed come from ``structure_seed``; the
run's seed draws only the measurement noise.

Vertex ids follow first use, as SLAM++'s flat system reads them: each pose
takes the next id, then the trees it sees first.  Edges are in file order,
by their newer vertex, a pose's odometry before its sightings.  A sighting
is written as ``LANDMARK2:XY`` (the tree in the pose's frame, with the
information SLAM++ discards), which the parser turns into range and
bearing with identity information; odometry as ``EDGE2``.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from benchmark.scenes import g2o
from benchmark.scenes.manhattan_2d import walk

#: the information written on a sighting (the parser replaces it)
OBS_INFO = " 1 0 1"


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


@dataclass
class LandmarkScene:
    poses: np.ndarray       # [N, 3] ground truth (not written)
    landmarks: np.ndarray   # [L, 2] ground truth (not written)
    pose_id: np.ndarray     # [N] vertex id of each pose
    landmark_id: np.ndarray  # [L] vertex id of each tree
    edge_i: np.ndarray      # [K] in file order: the pose
    edge_j: np.ndarray      # [K]: the next pose (odometry) or the tree
    odometry: np.ndarray    # [K] bool: EDGE2, else LANDMARK2:XY
    z: np.ndarray           # [K, 3]: odometry (x, y, theta); a sighting's x, y and 0
    info: np.ndarray        # [K, 3, 3]: odometry's; zeros on a sighting

    @property
    def n_poses(self) -> int:
        return len(self.poses)

    @property
    def n_landmarks(self) -> int:
        return len(self.landmarks)

    @property
    def n_edges(self) -> int:
        return len(self.edge_i)

    def write(self, path: str) -> None:
        iu = np.triu_indices(3)
        odo, obs = self.odometry, ~self.odometry
        texts = []
        for mask, token, floats, tail in (
                (odo, "EDGE2", np.concatenate([self.z, self.info[:, iu[0], iu[1]]], 1), ""),
                (obs, "LANDMARK2:XY", self.z[:, :2], OBS_INFO)):
            buf = io.BytesIO()
            g2o.write_lines(buf, token, np.stack([self.edge_i[mask], self.edge_j[mask]], 1),
                            floats[mask], tail)
            texts.append(buf.getvalue().splitlines(keepends=True))
        # the two kinds' lines back in file order
        lines = np.empty(self.n_edges, dtype=object)
        lines[odo], lines[obs] = texts
        with open(path, "wb") as f:
            f.write(b"".join(lines))

    def as_read(self) -> "LandmarkScene":
        return LandmarkScene(self.poses, self.landmarks, self.pose_id, self.landmark_id,
                             self.edge_i, self.edge_j, self.odometry, g2o.as_read(self.z),
                             g2o.as_read(self.info))

    def prefix(self, n_poses: int) -> "LandmarkScene":
        """The stream's first n_poses poses, the trees they saw and every
        edge among them."""
        if n_poses >= self.n_poses:
            return self
        end = self.pose_id[n_poses]          # ids below it: those poses and trees
        keep = np.maximum(self.edge_i, self.edge_j) < end
        seen = self.landmark_id < end
        return LandmarkScene(self.poses[:n_poses], self.landmarks[seen], self.pose_id[:n_poses],
                             self.landmark_id[seen], self.edge_i[keep], self.edge_j[keep],
                             self.odometry[keep], self.z[keep], self.info[keep])


def generate(params: dict, seed: int) -> LandmarkScene:
    """The scene of params for seed (see the module's docstring)."""
    n, n_lm = int(params["n_poses"]), int(params["n_landmarks"])
    n_obs, structure = int(params["observations"]), int(params["structure_seed"])
    radius = float(params["radius"])
    poses = walk(n, float(params["step"]), np.random.default_rng(structure))
    rng = np.random.default_rng([structure, 2])
    # trees: a uniform offset in the disc around a pose of the walk
    landmarks = np.zeros((n_lm, 2))
    in_range = np.zeros((n, n_lm), dtype=bool)
    for k in range(n_lm):
        while True:
            r, a = radius * np.sqrt(rng.random()), 2 * np.pi * rng.random()
            landmarks[k] = poses[rng.integers(n), :2] + r * np.array([np.cos(a), np.sin(a)])
            in_range[:, k] = np.sum((poses[:, :2] - landmarks[k]) ** 2, axis=1) < radius ** 2
            if in_range[:, k].sum() >= 2:
                break
    # two sightings of each tree, then the rest uniformly over the other pairs
    chosen = np.zeros_like(in_range)
    for k in range(n_lm):
        chosen[rng.choice(np.flatnonzero(in_range[:, k]), 2, replace=False), k] = True
    rest = np.flatnonzero((in_range & ~chosen).reshape(-1))
    more = n_obs - 2 * n_lm
    if not 0 <= more <= len(rest):
        raise ValueError(f"{n_obs} observations asked: {2 * n_lm} first sightings and "
                         f"{len(rest)} other pairs within the radius")
    chosen.reshape(-1)[rng.choice(rest, more, replace=False)] = True
    op, ol = np.nonzero(chosen)             # by pose, then by tree

    # ids by first use: each pose, then the trees it sees first
    first = np.full(n_lm, n)
    np.minimum.at(first, ol, op)
    order = np.lexsort((np.arange(n_lm), first))        # trees by first sighting
    new_at = np.bincount(first, minlength=n + 1)[:n]
    pose_id = np.arange(n) + np.concatenate([[0], np.cumsum(new_at)[:-1]])
    landmark_id = np.empty(n_lm, dtype=np.int64)
    landmark_id[order] = pose_id[first[order]] + 1 + (
        np.arange(n_lm) - np.concatenate([[0], np.cumsum(new_at)])[first[order]])

    ei = np.concatenate([pose_id[:-1], pose_id[op]])
    ej = np.concatenate([pose_id[1:], landmark_id[ol]])
    odo = np.arange(len(ei)) < n - 1
    # file order: by the newer vertex, odometry first, then by the older
    fo = np.lexsort((np.minimum(ei, ej), ~odo, np.maximum(ei, ej)))
    ei, ej, odo = ei[fo], ej[fo], odo[fo]
    src = np.concatenate([np.arange(n - 1), op])[fo]           # the measuring pose
    lm = np.concatenate([np.full(n - 1, -1), ol])[fo]          # the tree seen, or -1

    tn, rn, on = (float(params[k]) for k in ("trans_noise", "rot_noise", "obs_noise"))
    noise = np.random.default_rng(seed)
    k = len(ei)
    a = poses[src]
    b = np.where(odo[:, None], poses[np.minimum(src + 1, n - 1)],
                 np.concatenate([landmarks[np.maximum(lm, 0)], np.zeros((k, 1))], 1))
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    d = b[:, :2] - a[:, :2]
    z = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                  _wrap(b[:, 2] - a[:, 2])], 1)
    sig = np.where(odo[:, None], [tn, tn, rn], [on, on, 0.0])
    z = z + noise.normal(0.0, 1.0, (k, 3)) * sig
    z[:, 2] = np.where(odo, _wrap(z[:, 2]), 0.0)
    info = np.where(odo[:, None, None], np.diag([1.0 / tn ** 2, 1.0 / tn ** 2, 1.0 / rn ** 2]),
                    0.0)
    return LandmarkScene(poses, landmarks, pose_id, landmark_id, ei, ej, odo, z, info)
