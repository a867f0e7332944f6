"""Incremental bundle adjustment driven by CONSISTENCY_MARKER lines.

Port of slam_plus_plus_tpu/app/incremental_ba.py (reference analogue: the
3DV-2017 incremental BA demo, src/incremental_ba_3dv/Main.cpp:22-181): the
dataset interleaves camera / point vertices and observations with
CONSISTENCY_MARKER lines; at each marker the solver runs (the dogleg in the
reference) and may recover marginals.
"""

from __future__ import annotations

from typing import List

import numpy as np

from slam_plus_plus_tpu_torch.io.parser import parse_g2o


def parse_with_markers(path: str):
    """Parse fully (vertex initialization from the file: the BA layout),
    recording the edge count at each CONSISTENCY_MARKER."""
    markers: List[int] = []
    system = parse_g2o(path, on_marker=lambda s: markers.append(s.num_edges),
                       use_vertex_init=True)
    return system, markers


def run_incremental_ba(path: str, *, device, marginals: bool = False, solver: str = "dl"):
    """Replay the dataset on ``device``, solving at each marker.  Returns
    (final chi2, per-marker chi2 list, a MarginalsResult or None).

    solver="dl" (the reference demo's Lambda-DL): fluid relinearization,
    the incrementally maintained Schur complement and the maintained-state
    marginals (solvers/dogleg_incremental.py).  solver="lambda": the
    active-prefix GN replay of the incremental lambda solver's own path,
    assembled and solved by the Schur complement at each marker, with the
    batch marginals (gauge jitter 1e-10) of the final state.  Both run at
    most IncrementalDoglegSolver.MAX_ITERATIONS iterations per marker and
    stop at its DX_THRESHOLD (the JAX package's defaults)."""
    from slam_plus_plus_tpu_torch.solvers.dogleg_incremental import IncrementalDoglegSolver
    from slam_plus_plus_tpu_torch.solvers.incremental import IncrementalSolver

    if solver not in ("dl", "lambda"):
        raise ValueError(f"solver {solver!r}: dl or lambda")
    system, markers = parse_with_markers(path)
    if not markers:
        markers = [system.num_edges]

    if solver == "dl":
        s = IncrementalDoglegSolver(system, device=device)
        final_chi2, chi2_trace = s.run([m - 1 for m in markers])
        return final_chi2, chi2_trace, s.marginals() if marginals else None

    # every_n = 0: no solve schedule of its own; the markers drive it
    inc = IncrementalSolver(system, device=device, every_n=0,
                            max_iterations=IncrementalDoglegSolver.MAX_ITERATIONS,
                            dx_threshold=IncrementalDoglegSolver.DX_THRESHOLD)
    asm = inc.asm
    states = asm.snapshot_states(system)
    marker_set = set(m - 1 for m in markers)     # steps are 0-based
    counts = {n: 0 for n in asm.edge_data}
    chi2_trace = []
    for si, step in enumerate(inc.steps):
        for (slot, _gid) in step["new_vs"]:
            states = asm.place_vertex(states, step["ename"], slot, step["li"])
        counts[step["ename"]] += 1
        if si in marker_set:
            n_active = step["n_active"]
            states, _ = inc._optimize(states, counts, int(inc._p_prefix[n_active]),
                                      int(inc._l_prefix[n_active]))
            chi2_trace.append(float(asm.chi2_active(states, counts)))

    final_chi2 = float(asm.chi2_active(states, counts))
    asm.writeback_states(system, states)
    marg = None
    if marginals:
        from slam_plus_plus_tpu_torch.marginals import Marginals
        marg = Marginals(asm, gauge_jitter=1e-10).compute(asm.assemble(states))
    return final_chi2, chi2_trace, marg


def write_incremental_ba(path: str, cams, points, obs, cams_per_chunk: int = 2,
                         point_noise: float = 0.05, seed: int = 1):
    """Write an incremental-BA dataset: cameras arrive in chunks, each chunk
    followed by its observations and a CONSISTENCY_MARKER (the 3DV layout,
    data/Readme.txt incremental BA format).  Byte for byte the JAX
    package's writer."""
    rng = np.random.default_rng(seed)
    n_cams = len(cams)
    obs_by_cam = {}
    for (pid, cid, u, v) in obs:
        obs_by_cam.setdefault(cid, []).append((pid, u, v))
    noisy_pts = {p: pt + rng.normal(0, point_noise, 3) for p, pt in enumerate(points)}
    with open(path, "w") as f:
        seen_pts = set()
        for c0 in range(0, n_cams, cams_per_chunk):
            for c in range(c0, min(c0 + cams_per_chunk, n_cams)):
                (pos, q, fx, fy, cx, cy, d) = cams[c]
                f.write(f"VERTEX_CAM {c} " + " ".join(f"{v:.10f}" for v in pos) + " " +
                        " ".join(f"{v:.10f}" for v in q) + f" {fx} {fy} {cx} {cy} {d}\n")
                for (pid, u, v) in obs_by_cam.get(c, []):
                    gid = n_cams + pid
                    if pid not in seen_pts:
                        seen_pts.add(pid)
                        f.write(f"VERTEX_XYZ {gid} " +
                                " ".join(f"{x:.10f}" for x in noisy_pts[pid]) + "\n")
                    f.write(f"EDGE_PROJECT_P2MC {gid} {c} {u:.10f} {v:.10f} 1 0 1\n")
            f.write("CONSISTENCY_MARKER\n")
