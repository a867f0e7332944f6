"""The batch pose-graph rows of docs/ACCEPTANCE_TPU.md, made by the port's
generators at the settings of scripts/acceptance.py.

Each row: the CLI flags it runs with and the reference binary's final chi2
on the same file (docs/ACCEPTANCE_TPU.md:16-21), which the port's result is
gated against at 1.05 x.
"""

from __future__ import annotations

import os

from slam_plus_plus_tpu_torch.io import datasets as D

#: name -> (CLI flags, the reference binary's final chi2)
ROWS = {
    "manhattan3500": (["-po"], 1418.57),
    "city10k": (["-po"], 1429.33),
    "sphere2500": (["-lm", "-mfnsi", "30"], 34090.37),
    "trees10k": ([], 96531.99),
}
#: the gate on chi2 / golden
GATE = 1.05
#: rows whose gate float32 GN with the JAX package's settings misses on the
#: card, and where the miss is recorded
FLOAT32_MISSES = {"manhattan3500": "ROADMAP.md Queue 3"}


def dataset(name: str, directory: str) -> str:
    """Path of the row's g2o file in directory, written on first use."""
    path = os.path.join(directory, f"accept_{name}.g2o")
    if os.path.exists(path):
        return path
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    if name == "manhattan3500":
        poses, edges = D.make_manhattan_2d(n_poses=3500, seed=101, loop_prob=0.3)
        D.write_g2o_2d(tmp, edges, poses)
    elif name == "city10k":
        poses, edges = D.make_city_2d(n_poses=10000, seed=102)
        D.write_g2o_2d(tmp, edges, poses)
    elif name == "sphere2500":
        poses, edges = D.make_sphere_3d(n_poses=2500, seed=103, trans_noise=0.01,
                                        rot_noise=0.005)
        D.write_g2o_3d(tmp, edges, poses)
    elif name == "trees10k":
        _gp, _gl, pe, le = D.make_landmark_2d(n_poses=10000, n_landmarks=2000,
                                              world=110.0, obs_radius=8.0, seed=104)
        D.write_g2o_landmark_2d(tmp, pe, le)
    else:
        raise ValueError(f"no acceptance row {name!r}; rows: {', '.join(ROWS)}")
    os.replace(tmp, path)
    return path
