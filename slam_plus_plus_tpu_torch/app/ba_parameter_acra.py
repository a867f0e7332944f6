"""Landmark-parameterization comparison — the ba_parameter_acra analogue.

Port of slam_plus_plus_tpu/app/ba_parameter_acra.py (reference
src/ba_parameter_acra/MainL.cpp — experiments for the ACRA-2015 paper "The
Effect of Different Parameterisations in Incremental Structure from
Motion" (Lui, Ila, Drummond, Mahony): the same SfM sequence optimized
under XYZ / inverse-depth / inverse-distance landmark parameterizations,
reporting chi2 and convergence behavior).

One synthetic Sim(3) sequence, three GraphSystems (one per
parameterization, from the Sim(3) types of models/sim3_types.py), each
solved by Lambda-LM in float64 on the chosen device; the comparison table
is the program output.

    python -m slam_plus_plus_tpu_torch.app.ba_parameter_acra [n_cams] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

import slam_plus_plus_tpu_torch.models  # noqa: F401
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.models.sim3_types import _project_local, _world_to_cam
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

INTR = np.array([500.0, 500.0, 320.0, 240.0, 0.0])
#: pixel noise and seed of the sequence (the JAX defaults)
NOISE_PX = 0.3
SEED = 3


def _to_cam(cam, pw) -> np.ndarray:
    """World points [..., 3] in the frame of one cam_sim3 state, host float64."""
    return _world_to_cam(torch.as_tensor(cam), torch.as_tensor(pw)).numpy()


def make_sim3_sequence(n_cams=8, n_points=120):
    """Cameras on an arc observing a cloud; returns ground truth + pixel
    observations [(cam, point, uv)]."""
    rng = np.random.default_rng(SEED)
    points = rng.uniform(-1.5, 1.5, (n_points, 3))
    points[:, 2] += 5.0
    cams = []
    for c in range(n_cams):
        t = np.array([0.8 * np.sin(0.3 * c), 0.05 * c, 0.4 * c * 0.1])
        aa = np.array([0.0, 0.04 * np.sin(0.5 * c), 0.0])
        cams.append(np.concatenate([t, aa, [1.0], INTR]))
    obs = []
    intr = torch.as_tensor(INTR)
    for c, cam in enumerate(cams):
        x = _to_cam(cam[None], points)
        uv = _project_local(torch.as_tensor(x), *intr.unbind(-1)).numpy()
        for p in range(n_points):
            if x[p, 2] < 0.5:
                continue
            if 0 <= uv[p, 0] < 640 and 0 <= uv[p, 1] < 480:
                obs.append((c, p, uv[p] + rng.normal(0, NOISE_PX, 2)))
    return cams, points, obs


def _build(param: str, cams, points, obs, rng):
    """One GraphSystem under the given landmark parameterization.

    xyz: world-frame points + edge_p2c_sim3 (the G family).
    invdepth / invdist: owner-local landmarks (first observing camera owns
    the point) with LS unary self-observation + LO other-observation edges,
    exactly the reference's incremental-SfM structure."""
    sys_ = GraphSystem()
    n_cams = len(cams)
    for c, cam in enumerate(cams):
        sys_.add_vertex(c, "cam_sim3", cam)
    info2 = np.eye(2)
    owner_of: Dict[int, int] = {}
    first_obs: Dict[int, np.ndarray] = {}
    for (c, p, uv) in obs:
        if p not in owner_of:
            owner_of[p] = c
            first_obs[p] = uv
    noisy = {p: points[p] + rng.normal(0, 0.04, 3) for p in owner_of}
    for p, own in owner_of.items():
        vid = n_cams + p
        if param == "xyz":
            sys_.add_vertex(vid, "xyz", noisy[p])
        else:
            x = _to_cam(cams[own], noisy[p])
            if param == "invdepth":
                sys_.add_vertex(vid, "inv_depth",
                                np.array([x[0] / x[2], x[1] / x[2], 1.0 / x[2]]))
            else:
                # direction from the first OBSERVATION ray (pixel-accurate;
                # the reference's init practice — a direction derived from
                # the noisy 3D point would freeze perpendicular error into
                # the constant part of the parameterization), range from
                # the noisy point
                uv = first_obs[p]
                ray = np.array([(uv[0] - INTR[2]) / INTR[0],
                                (uv[1] - INTR[3]) / INTR[1], 1.0])
                ray /= np.linalg.norm(ray)
                sys_.add_vertex(vid, "inv_dist4",
                                np.concatenate([ray, [1.0 / np.linalg.norm(x)]]))
    for (c, p, uv) in obs:
        vid = n_cams + p
        own = owner_of[p]
        if param == "xyz":
            sys_.add_edge("edge_p2c_sim3", (c, vid), uv, info2)
        elif c == own:
            z7 = np.concatenate([uv, INTR])
            name = ("edge_p2c_invdepth_ls_u" if param == "invdepth"
                    else "edge_p2c_invdist_ls_u")
            sys_.add_edge(name, (vid,), z7, info2)
        else:
            name = ("edge_p2c_invdepth_lo" if param == "invdepth"
                    else "edge_p2c_invdist_lo")
            sys_.add_edge(name, (own, c, vid), uv, info2)
    return sys_


def run_comparison(n_cams=8, n_points=120, max_iters=10,
                   verbose=True, *, device="cuda") -> List[dict]:
    """The three parameterizations solved by LM on ``device`` in float64:
    one row each (param, n_edges, chi2_init, chi2_final, iters)."""
    cams, points, obs = make_sim3_sequence(n_cams, n_points)
    rows = []
    for param in ("xyz", "invdepth", "invdist"):
        rng = np.random.default_rng(99)
        sys_ = _build(param, cams, points, obs, rng)
        lm = LevenbergMarquardtSolver(sys_, device=device, dtype=torch.float64)
        chi0 = lm.chi2()
        chi2, iters = lm.optimize(max_iters)
        rows.append(dict(param=param, n_edges=len(obs), chi2_init=chi0,
                         chi2_final=chi2, iters=iters))
    if verbose:
        print(f"# acra parameterization study: {n_cams} cams, "
              f"{n_points} points, {len(obs)} observations")
        print(f"{'param':10s} {'chi2 init':>14s} {'chi2 final':>14s} "
              f"{'iters':>6s}")
        for r in rows:
            print(f"{r['param']:10s} {r['chi2_init']:14.2f} "
                  f"{r['chi2_final']:14.4f} {r['iters']:6d}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ba_parameter_acra")
    p.add_argument("n_cams", nargs="?", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch sees no CUDA device; "
              "run on a GPU or pass --device cpu", file=sys.stderr)
        return 2
    run_comparison(n_cams=args.n_cams, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
