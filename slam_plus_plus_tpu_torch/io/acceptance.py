"""The rows of docs/ACCEPTANCE_TPU.md that the port runs, made by the port's
generators: the batch pose-graph rows at the settings of
scripts/acceptance.py (manhattan3500, city10k, sphere2500, trees10k, and
intel-scale, garage3d and w100k, the reference suite's largest pose graph
at 100,000 poses), the BA rows venice-class (bench.py's scene: 100
cameras, 8000 points, seed 77, gated at bench.py's 222855.82) and
venice-real (871 cameras, 100,000 points, 800,000 observations) as
scripts/venice_real_tpu.py:38-41 makes it, and
the six incremental rows (-nsp 1, with and without -fL) on manhattan3500,
city10k, intel-scale and two landmark files, vp-scale and trees10k-incr
(scripts/acceptance.py:110-122).

Each row: the CLI flags it runs with and the reference binary's final chi2
on the same file (docs/ACCEPTANCE_TPU.md, docs/BENCH_NOTES.md:309-330 for
venice-real), which the port's result is gated against at 1.05 x.
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
    "venice-real": ([], 323432.49),     # BA: LM is the default
    "intel-scale": (["-po"], 392.09),
    "garage3d": (["-po", "-lm", "-mfnsi", "20"], 3.74),
    "w100k": (["-po"], 213795479.57),
    "venice-class": ([], 222855.82),    # the bench scene (bench.py's gate)
}
#: the BA rows (float32 on the card: the Schur route's dtype)
BA_ROWS = ("venice-class", "venice-real")
#: the pose-graph rows of the first pose-graph slice
POSE_ROWS = ("manhattan3500", "city10k", "sphere2500", "trees10k")
#: the pose-graph rows added with the rest of batch solving
REST_ROWS = ("w100k", "intel-scale", "garage3d")
#: incremental rows (docs/ACCEPTANCE_TPU.md:25-30): label -> (dataset, CLI
#: flags, the reference binary's final chi2, its iterations)
INCREMENTAL_ROWS = {
    "manhattan3500 -nsp 1": ("manhattan3500", ["-po", "-nsp", "1"], 1705.99, 534),
    "city10k -nsp 1": ("city10k", ["-po", "-nsp", "1"], 2893.34, 569),
    "manhattan3500 -nsp 1 -fL": ("manhattan3500", ["-po", "-nsp", "1", "-fL"], 1418.70, 534),
    "intel-scale -nsp 1 -fL": ("intel-scale", ["-po", "-nsp", "1", "-fL"], 392.53, 141),
    "vp-scale -nsp 1 -fL": ("vp-scale", ["-nsp", "1", "-fL"], 295.05, 3476),
    "trees10k-incr -nsp 1 -fL": ("trees10k-incr", ["-nsp", "1", "-fL"], 418.97, 4342),
}
#: venice-real's initial chi2 and its reference LM trajectory, 5 iterations
#: (docs/BENCH_NOTES.md:309-330)
VENICE_INITIAL_CHI2 = 42556937.59
VENICE_TRAJECTORY = (1343749.0, 429743.9, 351260.7, 327756.2, 323432.8)
#: the gate on chi2 / golden
GATE = 1.05
#: rows whose gate the card's path misses: label -> (where the miss is
#: recorded, the bound on chi2 / golden that the recorded readings set, or
#: None where the row is held only below its starting chi2).  None since
#: pose GN / LM run float64 on the card (solvers/gauss_newton.py::route_dtype):
#: float32 missed manhattan3500 (1.13 x) and drew w100k (ROADMAP.md Queue
#: 3, F1); the incremental rows run float64 too (config.float64_dtype).
FLOAT32_MISSES = {}


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
    elif name == "trees10k-incr":
        # the real cityTrees10k's density: ~14k measurements over 10k poses
        _gp, _gl, pe, le = D.make_landmark_2d(n_poses=10000, n_landmarks=2000,
                                              world=110.0, obs_radius=2.0, seed=104)
        D.write_g2o_landmark_2d(tmp, pe, le)
    elif name == "vp-scale":
        # victoria-park class: few landmarks, each observed many times
        _gp, _gl, pe, le = D.make_landmark_2d(n_poses=3400, n_landmarks=150,
                                              world=40.0, obs_radius=10.0, seed=7)
        D.write_g2o_landmark_2d(tmp, pe, le)
    elif name == "intel-scale":
        poses, edges = D.make_manhattan_2d(n_poses=800, seed=105, loop_prob=0.4)
        D.write_g2o_2d(tmp, edges, poses)
    elif name == "garage3d":
        _gt, edges = D.make_garage_3d(seed=9)
        D.write_g2o_3d_axisangle(tmp, edges)
    elif name == "w100k":
        poses, edges = D.make_city_2d(n_poses=100000, seed=77)
        D.write_g2o_2d(tmp, edges, poses)
    elif name == "venice-class":
        cams, pts, obs = D.make_ba_scene(n_cams=100, n_points=8000, seed=77)
        D.write_g2o_ba(tmp, cams, pts, obs)
    elif name == "venice-real":
        cams, pts, obs = D.make_ba_scene_large(n_cams=871, n_points=100000,
                                               obs_per_point=8, seed=871)
        D.write_g2o_ba(tmp, cams, pts, obs)
    else:
        raise ValueError(f"no acceptance row {name!r}; rows: {', '.join(ROWS)}")
    os.replace(tmp, path)
    return path
