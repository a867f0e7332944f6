"""BAOptimizer facade — the embedding API of bundle adjustment.

Port of slam_plus_plus_tpu/app/ba_optimizer.py (reference CBAOptimizer,
include/ba_interface_example/BAOptimizer.h:49, whose C API at :127-135 is
csrc/ba_c_api.cpp here): a narrow interface that feeds cameras, points and
reprojection edges one call at a time, optimizes on the device named at
construction, and reads back states and marginal covariances.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch import models  # noqa: F401  (registers types)
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.io.parser import _invert_cam_pose


class BAOptimizer:
    """Usage:
        opt = BAOptimizer(device="cuda")
        opt.add_cam_vertex_g2o(0, pos, quat_xyzw, fx, fy, cx, cy, d)
        opt.add_xyz_vertex(1, xyz)
        opt.add_p2c_edge(1, 0, uv, info2x2)
        chi2, iters = opt.optimize(5)
    """

    def __init__(self, *, device):
        """The solvers take the Schur complement for BA by themselves, so
        the reference's use_schur flag has no counterpart here."""
        self.device = torch.device(device)
        self.system = GraphSystem()
        self._solver = None

    # ---- feeding (the reference's Add_* functions) -----------------------

    def add_xyz_vertex(self, vertex_id: int, xyz) -> None:
        self.system.add_vertex(vertex_id, "xyz", np.asarray(xyz, float))

    def add_cam_vertex(self, vertex_id: int, pose6, intrinsics5) -> None:
        """pose6: the internal world->camera [t, axis-angle]; intrinsics5:
        [fx fy cx cy d] with d already scaled by the mean focal length."""
        self.system.add_vertex(vertex_id, "cam", np.concatenate(
            [np.asarray(pose6, float), np.asarray(intrinsics5, float)]))

    def add_cam_vertex_g2o(self, vertex_id: int, pos3, quat_xyzw, fx, fy, cx, cy, d) -> None:
        """A camera in the g2o VERTEX_CAM convention: its world pose and
        the raw distortion."""
        qx, qy, qz, qw = (float(v) for v in quat_xyzw)
        pose = _invert_cam_pose(np.asarray(pos3, float), qx, qy, qz, qw)
        self.system.add_vertex(vertex_id, "cam", np.concatenate(
            [pose, [fx, fy, cx, cy, d * 0.5 * (fx + fy)]]))

    def add_p2c_edge(self, point_id: int, cam_id: int, uv, info2x2) -> None:
        self.system.add_edge("edge_p2c", (cam_id, point_id), np.asarray(uv, float),
                             np.asarray(info2x2, float))

    # ---- optimization ---------------------------------------------------

    def optimize(self, max_iterations: int = 5):
        """Levenberg-Marquardt, as the reference's facade: (final chi2,
        iterations); the states are written back."""
        from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver
        self._solver = LevenbergMarquardtSolver(self.system, device=self.device)
        return self._solver.optimize(max_iterations)

    def chi2(self) -> float:
        from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
        if self._solver is None:
            self._solver = GaussNewtonSolver(self.system, device=self.device)
        return self._solver.chi2()

    # ---- state access (the reference's r_Vertex_State / Dump_*) ----------

    def vertex_state(self, vertex_id: int) -> np.ndarray:
        return self.system.vertex_state(vertex_id).copy()

    def n_vertices(self) -> int:
        return self.system.num_vertices

    def n_edges(self) -> int:
        return self.system.num_edges

    def dump_state(self, path: str) -> None:
        """Vertex states in insertion order, one line each (reference
        CFlatSystem::Dump)."""
        with open(path, "w") as f:
            for gid in self.system.vertex_order:
                f.write(" ".join(f"{x:.10f}" for x in self.system.vertex_state(gid)) + "\n")

    def dump_graph(self, path: str) -> None:
        """The graph in the g2o dialect (reference Dump_Graph): points as
        VERTEX_XYZ, cameras as comments holding their internal state, the
        edges as EDGE_PROJECT_P2MC."""
        with open(path, "w") as f:
            for gid in self.system.vertex_order:
                tname, li = self.system.vertex_directory[gid]
                st = self.system.vertex_stores[tname].states[li]
                if tname == "xyz":
                    f.write(f"VERTEX_XYZ {gid} " + " ".join(f"{v:.10f}" for v in st) + "\n")
                elif tname == "cam":
                    f.write(f"# VERTEX_CAM {gid} (internal) " +
                            " ".join(f"{v:.10f}" for v in st) + "\n")
            store = self.system.edge_stores.get("edge_p2c")
            for e in range(store.n if store is not None else 0):
                cam, pt = store.vertex_ids[e]
                z, i = store.measurements[e], store.informations[e]
                f.write(f"EDGE_PROJECT_P2MC {pt} {cam} {z[0]:.10f} {z[1]:.10f} "
                        f"{i[0, 0]} {i[0, 1]} {i[1, 1]}\n")

    def covariances(self):
        """Block-diagonal marginal covariances of cameras and points
        (MarginalsResult), float64 on the facade's device.  Mono BA is
        gauge-deficient (scale), so a 1e-10 jitter keeps Sigma finite, as
        the JAX facade's."""
        from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
        from slam_plus_plus_tpu_torch.marginals import Marginals
        asm = Assembler(self.system, device=self.device, dtype=torch.float64)
        bs = asm.assemble(asm.snapshot_states(self.system))
        return Marginals(asm, gauge_jitter=1e-10).compute(bs)
