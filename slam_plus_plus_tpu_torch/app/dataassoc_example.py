"""Marginals-driven data association, end to end.

Port of slam_plus_plus_tpu/app/dataassoc_example.py (reference
src/slam_dataassoc_example/Main.cpp and the compact-pose-SLAM association
loop): an incremental FastL replay maintains the per-vertex covariance
diagonal inside its loop (``marginals=True``); then the query pose is
tested against each candidate under the posterior: the relative-pose
distribution (evaluation/distances.py, reference include/slam/Distances.h),
reduced to 4D [x y z theta] by the rotation-magnitude transform (or the
view-direction one, ``transform=``), goes through the Mahalanobis gate
(``gate=``, GATE by default).

    python -m slam_plus_plus_tpu_torch.app.dataassoc_example [file.g2o] [--device cuda|cpu]

Without a file it writes a 120-pose sphere (make_sphere_3d, seed 4) into a
temporary directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List

import numpy as np

from slam_plus_plus_tpu_torch.evaluation.distances import (
    mahalanobis_distance2, mahalanobis_gate, relative_pose_distribution,
    rotation_magnitude_transform, view_direction_transform)
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

#: the gate on [x y z theta] (the JAX app's default)
GATE = np.array([1.0, 1.0, 1.0, 0.5])


#: transform name -> the distance transform it names (the JAX app's names)
TRANSFORMS = {"rotation_magnitude": rotation_magnitude_transform,
              "view_direction": view_direction_transform}


def run_association(system: GraphSystem, query: int, candidates: List[int],
                    gate=tuple(GATE), transform: str = "rotation_magnitude", *, device,
                    verbose: bool = False):
    """(decisions, solver): decisions[i] = (candidate id, mean4, accepted,
    squared Mahalanobis distance) of each candidate, judged under the
    maintained posterior of a FastL replay on ``device``: its relative
    pose reduced by ``transform`` (rotation_magnitude or view_direction)
    and held against ``gate`` on [x y z angle]."""
    if transform not in TRANSFORMS:
        raise ValueError(f"transform {transform!r}: one of {', '.join(TRANSFORMS)}")
    tf, gate = TRANSFORMS[transform], np.asarray(gate, dtype=float)
    sv = FastLSolver(system, device=device, every_n=1, marginals=True)
    sv.run()
    sig = sv.sigma_diag()
    if sig is None:
        raise RuntimeError("marginals were not maintained")
    sig = sig.cpu().numpy()
    asm = sv.asm
    d = min(asm.Bp, 6)

    def pose_and_sigma(gid):
        tname, li = system.vertex_directory[gid]
        cs = int(asm.type_cslot[tname][li])
        return system.vertex_stores[tname].data[li], sig[cs][:d, :d]

    xq, sq = pose_and_sigma(query)
    decisions = []
    for cid in candidates:
        xc, sc = pose_and_sigma(cid)
        m4, s4 = tf(*relative_pose_distribution(xq, xc, sq, sc))
        s4r = s4 + 1e-9 * np.eye(4)
        ok = mahalanobis_gate(m4, s4r, gate)
        decisions.append((cid, m4, bool(ok), mahalanobis_distance2(m4, s4r)))
        if verbose:
            print(f"candidate {cid}: |t|={np.linalg.norm(m4[:3]):.3f} theta={m4[3]:.3f} -> "
                  f"{'ASSOCIATE' if ok else 'reject'}")
    return decisions, sv


def main(argv=None) -> int:
    from slam_plus_plus_tpu_torch.io import datasets as D
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o

    p = argparse.ArgumentParser(prog="dataassoc_example")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch sees no CUDA device; "
              "run on a GPU or pass --device cpu", file=sys.stderr)
        return 2
    path = args.input
    if path is None:
        path = os.path.join(tempfile.mkdtemp(), "dataassoc_demo.g2o")
        poses, edges = D.make_sphere_3d(n_poses=120, trans_noise=0.01, rot_noise=0.005,
                                        seed=4)
        D.write_g2o_3d(path, edges, poses)
    system = parse_g2o(path)
    n = len(system.vertex_order)
    query = system.vertex_order[-1]
    candidates = system.vertex_order[:-1][::max(1, n // 12)]
    decisions, sv = run_association(system, query, candidates, device=args.device,
                                    verbose=True)
    n_acc = sum(1 for (_c, _m, ok, _d2) in decisions if ok)
    print(f"{n_acc}/{len(decisions)} candidates associated; marginals trace: "
          f"{sv.marginals_trace[:6]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
