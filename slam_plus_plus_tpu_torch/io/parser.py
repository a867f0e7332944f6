"""g2o-dialect parser: every token the JAX package's parser reads.

Port of slam_plus_plus_tpu/io/parser.py:

  * mono BA: ``VERTEX_CAM`` (world pose inverted into the internal
    world->camera form, distortion scaled by the mean focal length,
    reference include/slam_app/ParsePrimitives.h:861-927), ``VERTEX_XYZ`` and
    ``EDGE_PROJECT_P2MC`` / ``EDGE_P2C`` / ``EDGE_P2MC``;
  * BA with an intrinsics vertex: ``VERTEX_INTRINSICS`` and the ternary
    ``EDGE_PROJECT_P2MCI`` / ``EDGE_P2CI`` / ``EDGE_P2MCI``;
  * stereo BA: ``VERTEX_SCAM`` (a ``VERTEX_CAM`` plus the baseline) and
    ``EDGE_PROJECT_P2SC`` / ``EDGE_P2SC``;
  * spheron: ``VERTEX_SPHERON:QUAT`` and ``EDGE_SPHERON_XYZ``, whose points
    are created from their first observation (the files carry no
    ``VERTEX_XYZ``);
  * SE(2): ``EDGE2`` and its aliases, XY landmark edges (converted to
    range-bearing with identity information, SE2_Types.h:602-615) and RB
    landmark edges;
  * SE(3): ``EDGE3`` (RPY rotation), ``EDGE3:AXISANGLE``, the ternary
    ``EDGE3:TERNARY`` hyperedge and ``LANDMARK3:XYZ``;
  * ROCV: ``ROCV:RECEIVER`` / ``ROCV:RECEIVER_GTFAKE`` (pos_vel3d),
    ``ROCV:TRANSMITTER`` (a landmark3d holding the first 3 of its values),
    ``ROCV:TRANSMITTER_UF`` (a landmark prior whose parsed factor is the
    information), ``ROCV:DELTA_TIME`` and ``ROCV:RANGE``.

Information matrices arrive as upper-triangular listings.  As the reference
CLI does (CIgnoreAllVertexTraits, src/slam_app/Solve2DImpl.cpp:50), SE(2)/SE(3)
``VERTEX`` lines are counted and ignored unless ``use_vertex_init`` is set:
those vertices are initialized from the edges; ``VERTEX_XYZ`` is honoured
only when the dataset peeks as BA (or ``use_vertex_init`` is set).  The JAX
parser dispatches no Sim(3) token: ``VERTEX_CAM:SIM3`` and ``VERTEX:SIM3``
only set ``has_sim3`` in ``peek_dataset`` and are counted as unknown tokens
here as there (Sim(3) scenes are built in code).
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from slam_plus_plus_tpu_torch import models  # noqa: F401  (registers types)
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.models.se2_types import xy_measurement_to_polar



def _sym_from_upper(values: List[float], n: int) -> np.ndarray:
    """Upper-triangular row-major listing -> symmetric matrix."""
    m = np.zeros((n, n))
    k = 0
    for i in range(n):
        for j in range(i, n):
            m[i, j] = values[k]
            m[j, i] = values[k]
            k += 1
    return m


def _rpy_to_axis_angle(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Euler RPY -> axis-angle (reference 3DSolverBase quaternion route)."""
    cr, sr = math.cos(roll * 0.5), math.sin(roll * 0.5)
    cp, sp = math.cos(pitch * 0.5), math.sin(pitch * 0.5)
    cy, sy = math.cos(yaw * 0.5), math.sin(yaw * 0.5)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return _quat_to_axis_angle(w, x, y, z)


def _quat_to_axis_angle(w, x, y, z) -> np.ndarray:
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    if w < 0:
        w, x, y, z = -w, -x, -y, -z
    vn = math.sqrt(x * x + y * y + z * z)
    angle = 2.0 * math.atan2(vn, w)
    if vn < 1e-12:
        return np.zeros(3)
    return np.array([x, y, z]) * (angle / vn)


def _invert_cam_pose(pos: np.ndarray, qx, qy, qz, qw) -> np.ndarray:
    """g2o VERTEX_CAM world pose -> internal world->camera [t, axis-angle]."""
    n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    # inverse (conjugate)
    qw, qx, qy, qz = qw, -qx, -qy, -qz
    # t = q^-1 * (-pos)
    px, py, pz = -pos
    uvx = qy * pz - qz * py
    uvy = qz * px - qx * pz
    uvz = qx * py - qy * px
    uuvx = qy * uvz - qz * uvy
    uuvy = qz * uvx - qx * uvz
    uuvz = qx * uvy - qy * uvx
    t = np.array([px + 2 * (qw * uvx + uuvx),
                  py + 2 * (qw * uvy + uuvy),
                  pz + 2 * (qw * uvz + uuvz)])
    aa = _quat_to_axis_angle(qw, qx, qy, qz)
    return np.concatenate([t, aa])


def _cam_pose(vals) -> np.ndarray:
    """The world->camera [t, axis-angle] of a vertex line's <id> <position>
    <quat xyzw> fields."""
    pos = np.array([float(v) for v in vals[1:4]])
    qx, qy, qz, qw = (float(v) for v in vals[4:8])
    return _invert_cam_pose(pos, qx, qy, qz, qw)


class ParseStats:
    def __init__(self):
        self.lines = 0
        self.vertices = 0
        self.edges = 0
        self.markers = 0
        self.unknown_tokens: Dict[str, int] = {}


def peek_dataset(path: str, max_lines: int = 5000) -> Dict[str, bool]:
    """Pre-parse probe deciding the problem family (reference TDatasetPeeker).

    Returns flags: has_se2, has_se3, has_landmark2d, has_landmark3d, has_ba,
    has_intrinsics, has_stereo, has_spheron, has_rocv, has_sim3.
    """
    flags = dict(has_se2=False, has_se3=False, has_landmark2d=False,
                 has_landmark3d=False, has_ba=False, has_intrinsics=False,
                 has_stereo=False, has_spheron=False, has_rocv=False,
                 has_sim3=False)
    with open(path) as f:
        for i, line in enumerate(f):
            if i >= max_lines:
                break
            tok = line.split(maxsplit=1)[0].upper() if line.strip() else ""
            if tok in ("EDGE2", "EDGE_SE2", "EDGE", "ODOMETRY", "VERTEX2", "VERTEX_SE2"):
                flags["has_se2"] = True
            elif tok in ("LANDMARK2:XY", "EDGE_SE2_XY", "LANDMARK",
                         "EDGE_BEARING_SE2_XY", "LANDMARK2:RB",
                         "EDGE_SE2_RB", "EDGE_BEARING_SE2_RB"):
                flags["has_landmark2d"] = True
            elif tok in ("EDGE3", "EDGE_SE3", "EDGE3:AXISANGLE", "EDGE_SE3:AXISANGLE", "VERTEX3", "VERTEX_SE3"):
                flags["has_se3"] = True
            elif tok in ("LANDMARK3:XYZ", "EDGE_SE3_XYZ"):
                flags["has_landmark3d"] = True
            elif tok in ("EDGE_PROJECT_P2MC", "EDGE_P2MC", "EDGE_P2C", "VERTEX_CAM"):
                flags["has_ba"] = True
            elif tok in ("EDGE_PROJECT_P2MCI", "EDGE_P2CI", "EDGE_P2MCI",
                         "VERTEX_INTRINSICS"):
                flags["has_ba"] = True
                flags["has_intrinsics"] = True
            elif tok in ("EDGE_PROJECT_P2SC", "EDGE_P2SC", "VERTEX_SCAM"):
                flags["has_stereo"] = True
            elif tok in ("VERTEX_SPHERON:QUAT", "EDGE_SPHERON_XYZ"):
                flags["has_spheron"] = True
            elif tok.startswith("ROCV"):
                flags["has_rocv"] = True
            elif tok in ("VERTEX_CAM:SIM3", "VERTEX:SIM3"):
                flags["has_sim3"] = True
    return flags


def parse_g2o(path: str, on_marker: Optional[Callable] = None,
              use_vertex_init: bool = False) -> GraphSystem:
    """Parse a dataset into a GraphSystem.

    on_marker(system) runs at each CONSISTENCY_MARKER, with the edges and
    vertices read so far (app/incremental_ba.py's marker steps).

    use_vertex_init=True honours SE(2)/SE(3) VERTEX lines instead of the
    reference CLI's default of initializing those vertices from edges, and
    VERTEX_XYZ whatever the dataset peeks as.  Otherwise VERTEX_XYZ belongs
    to the camera edges only when the dataset peeks as BA; elsewhere (3D
    landmark SLAM) it is ignored like the SE(3) vertex lines.
    """
    system = GraphSystem()
    stats = ParseStats()
    if use_vertex_init:
        is_ba = True
    else:
        peek = peek_dataset(path)
        is_ba = peek["has_ba"] or peek["has_stereo"] or peek["has_spheron"]

    with open(path) as f:
        for line in f:
            stats.lines += 1
            line = line.strip()
            if not line or line.startswith(("#", "%", "//")):
                continue
            parts = line.split()
            tok = parts[0].upper()
            try:
                _dispatch_line(tok, parts[1:], system, stats, is_ba, use_vertex_init)
                if on_marker and tok == "CONSISTENCY_MARKER":
                    on_marker(system)
            except (IndexError, ValueError):
                # reference: "error: line N: line is truncated" + continue
                # (reference include/slam_app/ParsePrimitives.h:594-597)
                print(f"error: line {stats.lines}: line is truncated",
                      file=sys.stderr)
    system.parse_stats = stats
    return system


def _floats(vals):
    return np.array([float(v) for v in vals])


def _dispatch_line(tok, vals, system, stats, is_ba, use_vertex_init):
    if tok in ("VERTEX2", "VERTEX_SE2", "VERTEX"):
        stats.vertices += 1
        if use_vertex_init:
            system.add_vertex(int(vals[0]), "pose2d", _floats(vals[1:4]))
    elif tok in ("VERTEX3", "VERTEX_SE3"):
        stats.vertices += 1
        if use_vertex_init:
            # RPY in the file, axis-angle inside (CVertex3DParsePrimitive,
            # reference include/slam_app/ParsePrimitives.h:782-799)
            aa = _rpy_to_axis_angle(float(vals[4]), float(vals[5]), float(vals[6]))
            system.add_vertex(int(vals[0]), "pose3d", np.concatenate([_floats(vals[1:4]), aa]))
    elif tok in ("EDGE2", "EDGE_SE2", "EDGE", "ODOMETRY"):
        i, j = int(vals[0]), int(vals[1])
        z = np.array([float(v) for v in vals[2:5]])
        info = _sym_from_upper([float(v) for v in vals[5:11]], 3)
        _add_edge(system, stats, "edge_pose2d", (i, j), z, info)
    elif tok in ("LANDMARK2:XY", "EDGE_SE2_XY", "LANDMARK", "EDGE_BEARING_SE2_XY"):
        i, j = int(vals[0]), int(vals[1])
        z, info = xy_measurement_to_polar(np.array([float(vals[2]), float(vals[3])]))
        _add_edge(system, stats, "edge_pose_landmark2d", (i, j), z, info)
    elif tok in ("LANDMARK2:RB", "EDGE_SE2_RB", "EDGE_BEARING_SE2_RB"):
        i, j = int(vals[0]), int(vals[1])
        z = np.array([float(vals[2]), float(vals[3])])
        info = _sym_from_upper([float(v) for v in vals[4:7]], 2)
        _add_edge(system, stats, "edge_pose_landmark2d", (i, j), z, info)
    elif tok in ("EDGE3", "EDGE_SE3"):
        # default dialect: relative pose with RPY rotation
        i, j = int(vals[0]), int(vals[1])
        aa = _rpy_to_axis_angle(float(vals[5]), float(vals[6]), float(vals[7]))
        z = np.concatenate([np.array([float(v) for v in vals[2:5]]), aa])
        info = _sym_from_upper([float(v) for v in vals[8:29]], 6)
        _add_edge(system, stats, "edge_pose3d", (i, j), z, info)
    elif tok in ("EDGE3:AXISANGLE", "EDGE_SE3:AXISANGLE"):
        i, j = int(vals[0]), int(vals[1])
        z = np.array([float(v) for v in vals[2:8]])
        info = _sym_from_upper([float(v) for v in vals[8:29]], 6)
        _add_edge(system, stats, "edge_pose3d", (i, j), z, info)
    elif tok in ("EDGE3:TERNARY", "EDGE_SE3_TERNARY"):
        # <i> <j> <k> <t xyz> <axis-angle> <info 6x6 upper>
        i, j, k = int(vals[0]), int(vals[1]), int(vals[2])
        z = np.array([float(v) for v in vals[3:9]])
        info = _sym_from_upper([float(v) for v in vals[9:30]], 6)
        _add_edge(system, stats, "edge_pose3d_ternary", (i, j, k), z, info)
    elif tok in ("LANDMARK3:XYZ", "EDGE_SE3_XYZ"):
        i, j = int(vals[0]), int(vals[1])
        z = np.array([float(v) for v in vals[2:5]])
        info = _sym_from_upper([float(v) for v in vals[5:11]], 3)
        _add_edge(system, stats, "edge_pose_landmark3d", (i, j), z, info)
    elif tok in ("VERTEX_CAM", "VERTEX_SCAM"):
        # <id> <position> <quat xyzw> <fx fy cx cy d> [<baseline>]
        vid = int(vals[0])
        fx, fy, cx, cy, d = (float(v) for v in vals[8:13])
        extra = [float(vals[13])] if tok == "VERTEX_SCAM" else []
        state = np.concatenate([_cam_pose(vals), [fx, fy, cx, cy, d * 0.5 * (fx + fy)],
                                extra])
        system.add_vertex(vid, "cam" if tok == "VERTEX_CAM" else "scam", state)
        stats.vertices += 1
    elif tok == "VERTEX_INTRINSICS":
        vid = int(vals[0])
        fx, fy, cx, cy, d = (float(v) for v in vals[1:6])
        system.add_vertex(vid, "intrinsics", np.array([fx, fy, cx, cy, d * 0.5 * (fx + fy)]))
        stats.vertices += 1
    elif tok == "VERTEX_SPHERON:QUAT":
        system.add_vertex(int(vals[0]), "spheron", _cam_pose(vals))
        stats.vertices += 1
    elif tok == "VERTEX_XYZ":
        stats.vertices += 1
        if is_ba:
            vid = int(vals[0])
            system.add_vertex(vid, "xyz", np.array([float(v) for v in vals[1:4]]))
    elif tok in ("EDGE_PROJECT_P2MC", "EDGE_P2C", "EDGE_P2MC"):
        # <pt-id> <cam-id> <ox> <oy> <info 2x2 upper>
        pt, cam = int(vals[0]), int(vals[1])
        z = np.array([float(vals[2]), float(vals[3])])
        info = _sym_from_upper([float(v) for v in vals[4:7]], 2)
        _add_edge(system, stats, "edge_p2c", (cam, pt), z, info)
    elif tok in ("EDGE_PROJECT_P2MCI", "EDGE_P2CI", "EDGE_P2MCI"):
        # <pt-id> <cam-id> <intrinsics-id> <ox> <oy> <info 2x2 upper>
        pt, cam, intr = int(vals[0]), int(vals[1]), int(vals[2])
        z = np.array([float(vals[3]), float(vals[4])])
        info = _sym_from_upper([float(v) for v in vals[5:8]], 2)
        _add_edge(system, stats, "edge_p2ci", (cam, pt, intr), z, info)
    elif tok in ("EDGE_PROJECT_P2SC", "EDGE_P2SC", "EDGE_SPHERON_XYZ"):
        # <pt-id> <cam-id> <3 values> <info 3x3 upper>
        pt, cam = int(vals[0]), int(vals[1])
        z = np.array([float(v) for v in vals[2:5]])
        info = _sym_from_upper([float(v) for v in vals[5:11]], 3)
        etype = "edge_spheron_xyz" if tok == "EDGE_SPHERON_XYZ" else "edge_p2sc"
        _add_edge(system, stats, etype, (cam, pt), z, info)
    elif tok == "ROCV:TRANSMITTER":
        # the reference parses 6 values (TVertex3D); the landmark holds 3
        stats.vertices += 1
        system.add_vertex(int(vals[0]), "landmark3d", _floats(vals[1:4]))
    elif tok == "ROCV:TRANSMITTER_UF":
        # unary anchor: the parsed factor IS the information ("elements are
        # not square roots", reference ROCV_Types.h:251,280-312)
        info = _sym_from_upper([float(v) for v in vals[1:7]], 3)
        _add_edge(system, stats, "edge_landmark3d_prior", (int(vals[0]),), np.zeros(3), info)
    elif tok in ("ROCV:RECEIVER", "ROCV:RECEIVER_GTFAKE"):
        stats.vertices += 1
        system.add_vertex(int(vals[0]), "pos_vel3d", _floats(vals[1:7]))
    elif tok == "ROCV:DELTA_TIME":
        info = _sym_from_upper([float(v) for v in vals[3:24]], 6)
        _add_edge(system, stats, "edge_rocv_const_vel", (int(vals[0]), int(vals[1])),
                  np.array([float(vals[2])]), info)
    elif tok == "ROCV:RANGE":
        _add_edge(system, stats, "edge_rocv_range", (int(vals[0]), int(vals[1])),
                  np.array([float(vals[2])]), np.array([[float(vals[3])]]))
    elif tok == "CONSISTENCY_MARKER":
        stats.markers += 1  # parse_g2o's on_marker hook acts on it
    elif tok in ("EQUIV", "PHASE"):
        pass  # bookkeeping tokens, ignored like the reference's CIgnore list
    else:
        stats.unknown_tokens[tok] = stats.unknown_tokens.get(tok, 0) + 1


def _add_edge(system, stats, type_name, vertex_ids, z, info):
    system.add_edge(type_name, vertex_ids, z, info)
    stats.edges += 1
