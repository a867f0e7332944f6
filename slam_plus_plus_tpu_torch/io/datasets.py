"""Synthetic datasets (port of the generators in
slam_plus_plus_tpu/io/datasets.py): a Manhattan-world 2D pose graph
(manhattanOlson analogue), a large city 2D pose graph (city10k / w100K
class), a 3D sphere walk (sphere2500 analogue), a 2D landmark dataset
(cityTrees analogue), BA scenes (venice analogue, and its 871-camera /
100k-point scale), stereo, intrinsics, spheron and mixed BA files, a
range-only constant-velocity (ROCV) scene, a parking-garage SE(3) graph,
and two Sim(3) scenes, which have no file format in either package and are
returned as vertex and edge lists for ``fill_system``.

Seeded numpy (the garage's relative poses go through the port's own se3 in
float64 on the CPU): the same arguments give the same file, byte for byte,
as the JAX package's generators.
"""

from __future__ import annotations

import numpy as np


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def make_manhattan_2d(n_poses=600, step=1.0, trans_noise=0.05, rot_noise=0.02,
                      loop_prob=0.2, loop_radius=2.0, seed=0):
    """Manhattan-world 2D pose graph: grid random walk + noisy odometry +
    nearest-neighbor loop closures.  Returns (gt_poses [N,3], edges).

    edges: list of (i, j, z[3], info[3,3]).
    """
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_poses, 3))
    heading = 0.0
    pos = np.zeros(2)
    for i in range(1, n_poses):
        if rng.random() < 0.25:
            heading = _wrap(heading + rng.choice([-1, 1]) * np.pi / 2)
        pos = pos + step * np.array([np.cos(heading), np.sin(heading)])
        poses[i] = [pos[0], pos[1], heading]

    info_t = 1.0 / (trans_noise ** 2)
    info_r = 1.0 / (rot_noise ** 2)
    info = np.diag([info_t, info_t, info_r])

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         _wrap(b[2] - a[2])])

    edges = []
    for i in range(n_poses - 1):
        z = rel(poses[i], poses[i + 1])
        z[:2] += rng.normal(0, trans_noise, 2)
        z[2] = _wrap(z[2] + rng.normal(0, rot_noise))
        edges.append((i, i + 1, z, info))

    # loop closures to previously visited nearby poses
    for j in range(10, n_poses):
        if rng.random() >= loop_prob:
            continue
        d2 = np.sum((poses[:j - 5, :2] - poses[j, :2]) ** 2, axis=1)
        i = int(np.argmin(d2))
        if d2[i] < loop_radius ** 2:
            z = rel(poses[i], poses[j])
            z[:2] += rng.normal(0, trans_noise, 2)
            z[2] = _wrap(z[2] + rng.normal(0, rot_noise))
            edges.append((i, j, z, info))
    return poses, edges


def make_city_2d(n_poses=10000, step=1.0, trans_noise=0.05, rot_noise=0.02,
                 loop_prob=0.25, loop_radius=1.5, seed=0):
    """Large-scale 2D pose graph (city10k/w100K class): grid random walk
    with O(n) spatially-bucketed loop-closure search.  Returns
    (gt_poses [N,3], edges) like make_manhattan_2d."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_poses, 3))
    heading = 0.0
    pos = np.zeros(2)
    # confine the walk to a box so revisits (closures) happen at any scale
    box = max(20.0, 1.2 * np.sqrt(n_poses))
    for i in range(1, n_poses):
        if rng.random() < 0.25:
            heading = _wrap(heading + rng.choice([-1, 1]) * np.pi / 2)
        nxt = pos + step * np.array([np.cos(heading), np.sin(heading)])
        if np.abs(nxt).max() > box:
            heading = _wrap(heading + np.pi / 2)
            nxt = pos + step * np.array([np.cos(heading), np.sin(heading)])
        pos = nxt
        poses[i] = [pos[0], pos[1], heading]

    info_t = 1.0 / (trans_noise ** 2)
    info_r = 1.0 / (rot_noise ** 2)
    info = np.diag([info_t, info_t, info_r])

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         _wrap(b[2] - a[2])])

    edges = []
    for i in range(n_poses - 1):
        z = rel(poses[i], poses[i + 1])
        z[:2] += rng.normal(0, trans_noise, 2)
        z[2] = _wrap(z[2] + rng.normal(0, rot_noise))
        edges.append((i, i + 1, z, info))

    # closures: spatial hash of cell -> most recent pose seen there
    cell_last = {}
    for j in range(n_poses):
        key = (int(np.floor(poses[j, 0] / loop_radius)),
               int(np.floor(poses[j, 1] / loop_radius)))
        prev = cell_last.get(key)
        if (prev is not None and j - prev > 10 and
                rng.random() < loop_prob):
            i = prev
            z = rel(poses[i], poses[j])
            z[:2] += rng.normal(0, trans_noise, 2)
            z[2] = _wrap(z[2] + rng.normal(0, rot_noise))
            edges.append((i, j, z, info))
        cell_last[key] = j
    return poses, edges


def write_g2o_2d(path, edges, poses=None):
    """Write a SLAM++-dialect 2D file (EDGE2 with upper-tri info).

    Edges are written in chronological order (sorted by max vertex id) so
    loop closures interleave with odometry — required for incremental
    replay to behave like the real datasets."""
    edges = sorted(edges, key=lambda e: max(e[0], e[1]))
    with open(path, "w") as f:
        if poses is not None:
            for i, p in enumerate(poses):
                f.write(f"VERTEX2 {i} {p[0]:.10f} {p[1]:.10f} {p[2]:.10f}\n")
        for (i, j, z, info) in edges:
            ut = [info[0, 0], info[0, 1], info[0, 2], info[1, 1], info[1, 2],
                  info[2, 2]]
            f.write(f"EDGE2 {i} {j} " + " ".join(f"{v:.10f}" for v in z) + " " +
                    " ".join(f"{v:.10f}" for v in ut) + "\n")


def make_sphere_3d(n_poses=300, radius=10.0, trans_noise=0.02, rot_noise=0.01,
                   seed=0):
    """3D sphere pose graph (sphere2500 analogue): spiral walk on a sphere
    with odometry + vertical loop closures.  Returns (gt [N,6] tRs-free
    [t, axis-angle], edges)."""
    rng = np.random.default_rng(seed)

    def aa_to_R(aa):
        th = np.linalg.norm(aa)
        if th < 1e-12:
            return np.eye(3)
        k = aa / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    def R_to_aa(R):
        tr = np.trace(R)
        c = np.clip((tr - 1) / 2, -1, 1)
        th = np.arccos(c)
        if th < 1e-9:
            return np.zeros(3)
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return v * th / (2 * np.sin(th))

    n_rings = max(6, int(np.sqrt(n_poses)))
    per_ring = n_poses // n_rings
    poses_R, poses_t = [], []
    for r in range(n_rings):
        phi = np.pi * (r + 0.5) / n_rings
        for k in range(per_ring):
            theta = 2 * np.pi * k / per_ring
            t = radius * np.array([np.sin(phi) * np.cos(theta),
                                   np.sin(phi) * np.sin(theta), np.cos(phi)])
            # heading along the ring
            fwd = np.array([-np.sin(theta), np.cos(theta), 0.0])
            up = t / np.linalg.norm(t)
            left = np.cross(up, fwd)
            left /= np.linalg.norm(left) + 1e-12
            fwd = np.cross(left, up)
            R = np.stack([fwd, left, up], axis=1)
            poses_R.append(R)
            poses_t.append(t)
    N = len(poses_t)
    gt = np.zeros((N, 6))
    for i in range(N):
        gt[i, :3] = poses_t[i]
        gt[i, 3:] = R_to_aa(poses_R[i])

    def rel(i, j):
        Ri, ti = poses_R[i], poses_t[i]
        Rj, tj = poses_R[j], poses_t[j]
        Rrel = Ri.T @ Rj
        trel = Ri.T @ (tj - ti)
        return trel, Rrel

    info = np.diag([1.0 / trans_noise ** 2] * 3 + [1.0 / rot_noise ** 2] * 3)
    edges = []

    def noisy_edge(i, j):
        trel, Rrel = rel(i, j)
        trel = trel + rng.normal(0, trans_noise, 3)
        Rn = aa_to_R(rng.normal(0, rot_noise, 3))
        z = np.concatenate([trel, R_to_aa(Rrel @ Rn)])
        return (i, j, z, info)

    for i in range(N - 1):
        edges.append(noisy_edge(i, i + 1))
    # dense loop closures (the real sphere2500 has several closures per pose;
    # sparse closures leave the gauge weakly constrained and make batch GN
    # unstable — the reference binary diverges on such graphs)
    for j in range(per_ring, N):
        edges.append(noisy_edge(j - per_ring, j))        # pose below
        if j - per_ring - 1 >= 0:
            edges.append(noisy_edge(j - per_ring - 1, j))  # diagonal below
    for j in range(2, N):
        if j % 3 == 0:
            edges.append(noisy_edge(j - 2, j))           # in-ring skip
    return gt, edges


def _aa_to_rpy(aa):
    """Axis-angle -> [roll, pitch, yaw] with R = Rz(yaw) Ry(pitch) Rx(roll),
    the reference's VERTEX3 file convention
    (reference include/slam_app/ParsePrimitives.h:782-793)."""
    th = np.linalg.norm(aa)
    if th < 1e-12:
        return np.zeros(3)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    roll = np.arctan2(R[2, 1], R[2, 2])
    pitch = -np.arcsin(np.clip(R[2, 0], -1, 1))
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])


def write_g2o_3d(path, edges, poses=None):
    """Write EDGE3:AXISANGLE dialect (upper-tri 6x6 info); VERTEX3 rotation
    is written as RPY per the reference's parse convention.  Edges are
    chronological (sorted by max vertex id) for incremental replay."""
    edges = sorted(edges, key=lambda e: max(e[0], e[1]))
    with open(path, "w") as f:
        if poses is not None:
            for i, p in enumerate(poses):
                rpy = _aa_to_rpy(np.asarray(p[3:6]))
                v = np.concatenate([p[:3], rpy])
                f.write(f"VERTEX3 {i} " + " ".join(f"{x:.10f}" for x in v) + "\n")
        for (i, j, z, info) in edges:
            ut = [info[a, b] for a in range(6) for b in range(a, 6)]
            f.write(f"EDGE3:AXISANGLE {i} {j} " +
                    " ".join(f"{v:.10f}" for v in z) + " " +
                    " ".join(f"{v:.10f}" for v in ut) + "\n")


def make_landmark_2d(n_poses=300, n_landmarks=120, world=25.0, obs_radius=6.0,
                     trans_noise=0.05, rot_noise=0.02, obs_noise=0.03, seed=0):
    """2D pose graph + XY landmark observations (cityTrees analogue).

    Vertex ids are assigned in order of first use (poses and landmarks share
    one id space), as the reference's flat system requires ("vertices must be
    accessed in incremental manner").  Returns (gt_poses, gt_landmarks,
    pose_edges, lm_edges) where edges already carry the final ids;
    lm_edges carry XY measurements (converted to polar by the parser rules).
    """
    rng = np.random.default_rng(seed)
    poses, raw_pose_edges = make_manhattan_2d(n_poses, trans_noise=trans_noise,
                                              rot_noise=rot_noise, loop_prob=0.05,
                                              seed=seed)
    scale = world / max(np.abs(poses[:, :2]).max(), 1.0)
    poses[:, :2] *= scale
    # odometry measurements must live in the SAME scaled frame as the poses
    # and landmark observations — an unscaled z makes the dataset
    # self-contradictory (huge residuals, chaotic optimization)
    raw_pose_edges = [(i, j, np.array([z[0] * scale, z[1] * scale, z[2]]),
                       info) for (i, j, z, info) in raw_pose_edges]
    landmarks = rng.uniform(-world, world, (n_landmarks, 2))

    # chronological observation sweep assigning dense ids on first use
    pose_id = {}
    lm_id = {}
    next_id = 0
    raw_lm_obs = []  # (pose_idx, lm_idx, local_xy) in chronological order
    for i, p in enumerate(poses):
        d2 = np.sum((landmarks - p[:2]) ** 2, axis=1)
        for li in np.flatnonzero(d2 < obs_radius ** 2):
            c, s = np.cos(p[2]), np.sin(p[2])
            d = landmarks[li] - p[:2]
            local = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
            local += rng.normal(0, obs_noise, 2)
            raw_lm_obs.append((i, li, local))

    obs_by_pose = {}
    for (i, li, local) in raw_lm_obs:
        obs_by_pose.setdefault(i, []).append((li, local))

    for i in range(n_poses):
        pose_id[i] = next_id
        next_id += 1
        for (li, _) in obs_by_pose.get(i, []):
            if li not in lm_id:
                lm_id[li] = next_id
                next_id += 1

    pose_edges = [(pose_id[i], pose_id[j], z, info)
                  for (i, j, z, info) in raw_pose_edges]
    lm_edges = [(pose_id[i], lm_id[li], local) for (i, li, local) in raw_lm_obs]
    return poses, landmarks, pose_edges, lm_edges


def write_g2o_landmark_2d(path, pose_edges, lm_edges, obs_info=None):
    """Write the edges interleaved in incremental vertex order: the reference's
    flat system requires each new vertex id to be exactly max_id+1 at first
    use ("vertices must be accessed in incremental manner",
    reference include/slam/FlatSystem.h:2457).  Since ids were assigned by
    first use, sorting edges by their max vertex id yields a valid order."""
    lines = []
    for (i, j, z, info) in pose_edges:
        ut = [info[0, 0], info[0, 1], info[0, 2], info[1, 1], info[1, 2],
              info[2, 2]]
        lines.append((max(i, j),
                      f"EDGE2 {i} {j} " + " ".join(f"{v:.10f}" for v in z) +
                      " " + " ".join(f"{v:.10f}" for v in ut) + "\n"))
    for (i, j, xy) in lm_edges:
        # LANDMARK2:XY info is parsed then *discarded* by the reference
        # (identity used); still write plausible values
        lines.append((max(i, j),
                      f"LANDMARK2:XY {i} {j} {xy[0]:.10f} {xy[1]:.10f} "
                      f"1 0 1\n"))
    lines.sort(key=lambda t: t[0])
    with open(path, "w") as f:
        for (_, line) in lines:
            f.write(line)


def make_ba_scene(n_cams=20, n_points=500, noise_px=0.5, seed=0,
                  f=500.0, cx=320.0, cy=240.0):
    """Synthetic BA problem (venice analogue): cameras on a ring looking at a
    point cloud.  Returns (cam_params list, points [N,3], observations).

    cam_params: (position[3], quat_xyzw[4], fx, fy, cx, cy, d) — g2o
    VERTEX_CAM convention (world pose).
    observations: (point_id, cam_id, u, v).
    """
    rng = np.random.default_rng(seed)
    points = rng.uniform(-2, 2, (n_points, 3))
    points[:, 2] += 6.0

    cams = []
    obs = []
    for c in range(n_cams):
        ang = 2 * np.pi * c / n_cams
        pos = np.array([3.0 * np.sin(ang), 0.5 * np.sin(2 * ang),
                        3.0 * np.cos(ang) - 0.5])
        # camera looks at the cloud centroid
        target = np.array([0.0, 0.0, 6.0])
        zaxis = target - pos
        zaxis /= np.linalg.norm(zaxis)
        xaxis = np.cross(np.array([0.0, 1.0, 0.0]), zaxis)
        xaxis /= np.linalg.norm(xaxis)
        yaxis = np.cross(zaxis, xaxis)
        R_wc = np.stack([xaxis, yaxis, zaxis], axis=1)  # cam->world
        # quaternion of R_wc (world pose rotation)
        qw = np.sqrt(max(0.0, 1 + np.trace(R_wc))) / 2
        if qw > 1e-9:
            qx = (R_wc[2, 1] - R_wc[1, 2]) / (4 * qw)
            qy = (R_wc[0, 2] - R_wc[2, 0]) / (4 * qw)
            qz = (R_wc[1, 0] - R_wc[0, 1]) / (4 * qw)
        else:
            qx, qy, qz = 1.0, 0.0, 0.0
        cams.append((pos, np.array([qx, qy, qz, qw]), f, f, cx, cy, 0.0))

        Rcw = R_wc.T
        for pid in range(n_points):
            pc = Rcw @ (points[pid] - pos)
            if pc[2] < 0.5:
                continue
            u = f * pc[0] / pc[2] + cx
            v = f * pc[1] / pc[2] + cy
            if 0 <= u < 2 * cx and 0 <= v < 2 * cy and rng.random() < 0.6:
                obs.append((pid, c, u + rng.normal(0, noise_px),
                            v + rng.normal(0, noise_px)))
    return cams, points, obs


def write_g2o_ba(path, cams, points, obs, point_noise=0.05, seed=1):
    """Write VERTEX_CAM / VERTEX_XYZ / EDGE_PROJECT_P2MC file; landmark
    initializations are perturbed so there is something to optimize."""
    rng = np.random.default_rng(seed)
    n_cams = len(cams)
    with open(path, "w") as f:
        for c, (pos, q, fx, fy, cx, cy, d) in enumerate(cams):
            f.write(f"VERTEX_CAM {c} " +
                    " ".join(f"{v:.10f}" for v in pos) + " " +
                    " ".join(f"{v:.10f}" for v in q) +
                    f" {fx} {fy} {cx} {cy} {d}\n")
        for p, pt in enumerate(points):
            noisy = pt + rng.normal(0, point_noise, 3)
            f.write(f"VERTEX_XYZ {n_cams + p} " +
                    " ".join(f"{v:.10f}" for v in noisy) + "\n")
        for (pid, cid, u, v) in obs:
            f.write(f"EDGE_PROJECT_P2MC {n_cams + pid} {cid} {u:.10f} {v:.10f} "
                    f"1 0 1\n")


def write_g2o_ba_stereo(path, cams, points, obs, baseline=0.1,
                        point_noise=0.05, seed=1):
    """VERTEX_SCAM / VERTEX_XYZ / EDGE_PROJECT_P2SC file.

    obs entries are (point_id, cam_id, u_l, v_l, u_r)."""
    rng = np.random.default_rng(seed)
    n_cams = len(cams)
    with open(path, "w") as f:
        for c, (pos, q, fx, fy, cx, cy, d) in enumerate(cams):
            f.write(f"VERTEX_SCAM {c} " +
                    " ".join(f"{v:.10f}" for v in pos) + " " +
                    " ".join(f"{v:.10f}" for v in q) +
                    f" {fx} {fy} {cx} {cy} {d} {baseline}\n")
        for p, pt in enumerate(points):
            noisy = pt + rng.normal(0, point_noise, 3)
            f.write(f"VERTEX_XYZ {n_cams + p} " +
                    " ".join(f"{v:.10f}" for v in noisy) + "\n")
        for (pid, cid, ul, vl, ur) in obs:
            f.write(f"EDGE_PROJECT_P2SC {n_cams + pid} {cid} "
                    f"{ul:.10f} {vl:.10f} {ur:.10f} 1 0 0 1 0 1\n")


def make_ba_stereo_obs(cams, points, baseline=0.1, noise_px=0.3, seed=0):
    """Stereo observations (u_l, v_l, u_r) for make_ba_scene-style cameras."""
    rng = np.random.default_rng(seed)
    obs = []
    for c, (pos, q, fx, fy, cx, cy, d) in enumerate(cams):
        qx, qy, qz, qw = q
        # world->cam rotation = conj of cam->world quat
        R = _quat_to_R(qw, qx, qy, qz).T
        for pid, pt in enumerate(points):
            pc = R @ (pt - pos)
            if pc[2] < 0.5:
                continue
            u = fx * pc[0] / pc[2] + cx
            v = fy * pc[1] / pc[2] + cy
            # right camera: world point shifted by -b along cam x-axis
            pc_r = R @ (pt - baseline * R.T[:, 0] - pos)
            ur = fx * pc_r[0] / pc_r[2] + cx
            if 0 <= u < 2 * cx and 0 <= v < 2 * cy and rng.random() < 0.6:
                obs.append((pid, c, u + rng.normal(0, noise_px),
                            v + rng.normal(0, noise_px),
                            ur + rng.normal(0, noise_px)))
    return obs


def _quat_to_R(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def write_g2o_ba_intrinsics(path, cams, points, obs, point_noise=0.05, seed=1):
    """VERTEX_CAM + VERTEX_INTRINSICS + EDGE_PROJECT_P2MCI file: all cameras
    share intrinsics vertex (the common BAI layout)."""
    rng = np.random.default_rng(seed)
    n_cams = len(cams)
    fx, fy, cx, cy, d = cams[0][2], cams[0][3], cams[0][4], cams[0][5], cams[0][6]
    with open(path, "w") as f:
        for c, (pos, q, *_rest) in enumerate(cams):
            f.write(f"VERTEX_CAM {c} " +
                    " ".join(f"{v:.10f}" for v in pos) + " " +
                    " ".join(f"{v:.10f}" for v in q) +
                    f" {fx} {fy} {cx} {cy} {d}\n")
        intr_id = n_cams
        f.write(f"VERTEX_INTRINSICS {intr_id} {fx} {fy} {cx} {cy} {d}\n")
        for p, pt in enumerate(points):
            noisy = pt + rng.normal(0, point_noise, 3)
            f.write(f"VERTEX_XYZ {intr_id + 1 + p} " +
                    " ".join(f"{v:.10f}" for v in noisy) + "\n")
        for (pid, cid, u, v) in obs:
            f.write(f"EDGE_PROJECT_P2MCI {intr_id + 1 + pid} {cid} {intr_id} "
                    f"{u:.10f} {v:.10f} 1 0 1\n")


def make_spheron_scene(n_poses=15, n_points=200, noise=0.01, seed=0):
    """Spherical-camera scene: poses on a line observing a point cloud; the
    spheron edge measures the landmark in the camera frame (XYZ)."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-4, 4, (n_points, 3)) + np.array([0, 0, 5.0])
    poses = []   # (pos, quat_xyzw) world pose
    obs = []     # (point_id, pose_id, xyz_local)
    for i in range(n_poses):
        pos = np.array([0.4 * i, 0.1 * np.sin(i), 0.0])
        q = np.array([0.0, 0.0, np.sin(0.02 * i), np.cos(0.02 * i)])  # yaw
        poses.append((pos, q))
        R = _quat_to_R(q[3], q[0], q[1], q[2]).T  # world->cam
        for pid in range(n_points):
            local = R @ (points[pid] - pos)
            if np.linalg.norm(local) < 12.0 and rng.random() < 0.5:
                obs.append((pid, i, local + rng.normal(0, noise, 3)))
    return poses, points, obs


def write_g2o_spheron(path, poses, points, obs, point_noise=0.05, seed=1):
    """Spheron dialect: NO VERTEX_XYZ lines — the reference dispatches files
    containing VERTEX_XYZ to the BA solver (peeker b_has_ba), so spheron
    datasets initialize points from the observation edges.  Edges are written
    in incremental vertex order (first use of each point id introduces it)."""
    n_poses = len(poses)
    # order observations so each point id first appears in increasing order
    first_obs = {}
    for k, (pid, i, xyz) in enumerate(obs):
        first_obs.setdefault(pid, k)
    order = sorted(range(len(obs)),
                   key=lambda k: (max(obs[k][1], n_poses + obs[k][0]), k))
    with open(path, "w") as f:
        for i, (pos, q) in enumerate(poses):
            f.write(f"VERTEX_SPHERON:QUAT {i} " +
                    " ".join(f"{v:.10f}" for v in pos) + " " +
                    " ".join(f"{v:.10f}" for v in q) + "\n")
        for k in order:
            (pid, i, xyz) = obs[k]
            f.write(f"EDGE_SPHERON_XYZ {n_poses + pid} {i} " +
                    " ".join(f"{v:.10f}" for v in xyz) +
                    " 1 0 0 1 0 1\n")


def make_ba_scene_large(n_cams=871, n_points=100000, obs_per_point=8,
                        noise_px=0.5, seed=0, f=500.0, cx=320.0, cy=240.0):
    """Vectorized venice-scale BA scene (reference data/venice871.g2o class:
    871 cams, ~100k+ points).  Each point is observed by exactly
    ``obs_per_point`` cameras (the nearest ones facing it), giving a uniform
    observation degree — the shape the sharded/uniform layouts like, at the
    pose count of the real dataset.  Returns (cams, points, obs) in
    make_ba_scene's format."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-2, 2, (n_points, 3))
    points[:, 2] += 6.0

    angs = 2 * np.pi * np.arange(n_cams) / n_cams
    pos = np.stack([3.0 * np.sin(angs), 0.5 * np.sin(2 * angs),
                    3.0 * np.cos(angs) - 0.5], axis=1)          # [C, 3]
    target = np.array([0.0, 0.0, 6.0])
    zaxis = target[None, :] - pos
    zaxis /= np.linalg.norm(zaxis, axis=1, keepdims=True)
    xaxis = np.cross(np.broadcast_to([0.0, 1.0, 0.0], zaxis.shape), zaxis)
    xaxis /= np.linalg.norm(xaxis, axis=1, keepdims=True)
    yaxis = np.cross(zaxis, xaxis)
    R_wc = np.stack([xaxis, yaxis, zaxis], axis=2)              # [C, 3, 3]

    cams = []
    for c in range(n_cams):
        R = R_wc[c]
        qw = np.sqrt(max(0.0, 1 + np.trace(R))) / 2
        if qw > 1e-9:
            q = np.array([(R[2, 1] - R[1, 2]) / (4 * qw),
                          (R[0, 2] - R[2, 0]) / (4 * qw),
                          (R[1, 0] - R[0, 1]) / (4 * qw), qw])
        else:
            q = np.array([1.0, 0.0, 0.0, 0.0])
        cams.append((pos[c], q, f, f, cx, cy, 0.0))

    # each point picks obs_per_point cameras, spread deterministically with a
    # random phase (cameras sit on a ring: nearby indices see similar views)
    base = rng.integers(0, n_cams, n_points)
    stride = max(1, n_cams // (3 * obs_per_point))
    cam_ids = (base[:, None] +
               stride * np.arange(obs_per_point)[None, :]) % n_cams  # [N, K]
    pid = np.repeat(np.arange(n_points), obs_per_point)
    cid = cam_ids.reshape(-1)
    # project (vectorized): p_cam = R_cw (p - t)
    Rcw = np.swapaxes(R_wc, 1, 2)[cid]                          # [E, 3, 3]
    pc = np.einsum("eij,ej->ei", Rcw, points[pid] - pos[cid])
    pc[:, 2] = np.maximum(pc[:, 2], 0.5)                        # keep in front
    u = f * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, noise_px, len(pid))
    v = f * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, noise_px, len(pid))
    obs = list(zip(pid.tolist(), cid.tolist(), u.tolist(), v.tolist()))
    return cams, points, obs


def write_g2o_ba_mixed(path, cams, points, mono_obs, stereo_obs,
                       baseline=0.1, point_noise=0.05, seed=1):
    """Mixed BA file: the first half of the cameras are monocular with a
    SHARED intrinsics vertex (ternary EDGE_PROJECT_P2MCI), the second half
    are stereo VERTEX_SCAM (EDGE_PROJECT_P2SC), all observing the same
    VERTEX_XYZ landmarks — the P2CI + stereo mixed-scene shape the sharded
    BA generality tests exercise (reference types BA_Types.h:562,705)."""
    rng = np.random.default_rng(seed)
    n_cams = len(cams)
    n_mono = n_cams // 2
    fx, fy, cx, cy, d = (cams[0][2], cams[0][3], cams[0][4], cams[0][5],
                         cams[0][6])
    with open(path, "w") as f:
        for c, (pos, q, *_rest) in enumerate(cams[:n_mono]):
            f.write(f"VERTEX_CAM {c} " +
                    " ".join(f"{v:.10f}" for v in pos) + " " +
                    " ".join(f"{v:.10f}" for v in q) +
                    f" {fx} {fy} {cx} {cy} {d}\n")
        for c, (pos, q, *_rest) in enumerate(cams[n_mono:]):
            f.write(f"VERTEX_SCAM {n_mono + c} " +
                    " ".join(f"{v:.10f}" for v in pos) + " " +
                    " ".join(f"{v:.10f}" for v in q) +
                    f" {fx} {fy} {cx} {cy} {d} {baseline}\n")
        intr_id = n_cams
        f.write(f"VERTEX_INTRINSICS {intr_id} {fx} {fy} {cx} {cy} {d}\n")
        for p, pt in enumerate(points):
            noisy = pt + rng.normal(0, point_noise, 3)
            f.write(f"VERTEX_XYZ {intr_id + 1 + p} " +
                    " ".join(f"{v:.10f}" for v in noisy) + "\n")
        for (pid, cid, u, v) in mono_obs:
            if cid < n_mono:
                f.write(f"EDGE_PROJECT_P2MCI {intr_id + 1 + pid} {cid} "
                        f"{intr_id} {u:.10f} {v:.10f} 1 0 1\n")
        for (pid, cid, ul, vl, ur) in stereo_obs:
            if cid >= n_mono:
                f.write(f"EDGE_PROJECT_P2SC {intr_id + 1 + pid} {cid} "
                        f"{ul:.10f} {vl:.10f} {ur:.10f} 1 0 0 1 0 1\n")


def make_rocv_scene(n_steps=100, n_transmitters=6, range_noise=0.02,
                    world=10.0, seed=0):
    """Range-only constant-velocity tracking scene: one receiver moving with
    piecewise-constant velocity, ranged against fixed transmitters."""
    rng = np.random.default_rng(seed)
    tx = rng.uniform(-world, world, (n_transmitters, 3))
    pos = np.zeros(3)
    vel = np.array([0.5, 0.3, 0.0])
    dt = 0.5
    traj = []
    for k in range(n_steps):
        if k % 20 == 10:
            vel = vel + rng.normal(0, 0.1, 3)
        pos = pos + dt * vel
        traj.append((pos.copy(), vel.copy()))
    ranges = []
    for k, (p, v) in enumerate(traj):
        for t in range(n_transmitters):
            if rng.random() < 0.7:
                r = np.linalg.norm(p - tx[t]) + rng.normal(0, range_noise)
                ranges.append((k, t, r))
    return tx, traj, ranges, dt


def write_g2o_rocv(path, tx, traj, ranges, dt, cv_info=100.0,
                   range_info=2500.0, prior_info=1e6):
    """ROCV:* dialect file."""
    n_steps = len(traj)
    with open(path, "w") as f:
        # receiver vertices first (ids 0..n-1), transmitters after
        for k, (p, v) in enumerate(traj):
            vals = np.concatenate([p, v])
            f.write(f"ROCV:RECEIVER {k} " +
                    " ".join(f"{x:.10f}" for x in vals) + "\n")
        for t in range(len(tx)):
            f.write(f"ROCV:TRANSMITTER {n_steps + t} " +
                    " ".join(f"{x:.10f}" for x in tx[t]) + " 0 0 0\n")
            sq = np.sqrt(prior_info)
            f.write(f"ROCV:TRANSMITTER_UF {n_steps + t} "
                    f"{sq} 0 0 {sq} 0 {sq}\n")
        info6 = np.eye(6) * cv_info
        ut6 = [f"{info6[a, b]}" for a in range(6) for b in range(a, 6)]
        for k in range(1, n_steps):
            f.write(f"ROCV:DELTA_TIME {k - 1} {k} {dt} " + " ".join(ut6) + "\n")
        for (k, t, r) in ranges:
            f.write(f"ROCV:RANGE {k} {n_steps + t} {r:.10f} {range_info}\n")


def _se3_relative(a, b):
    """b in a's frame for rows of [n, 6] float64 poses, through the port's
    se3 (the JAX generator uses the JAX se3 the same way)."""
    import torch
    from slam_plus_plus_tpu_torch.manifolds import se3
    return se3.relative_to(torch.from_numpy(np.asarray(a, dtype=np.float64)),
                           torch.from_numpy(np.asarray(b, dtype=np.float64))).numpy()


def make_garage_3d(n_loops=8, per_loop=200, climb=0.02, radius=8.0,
                   trans_noise=0.01, rot_noise=0.005, seed=9):
    """Parking-garage-class SE(3) pose graph (reference regression family
    `parking-garage.g2o`, scripts/tests/unit_tests.sh:170-175,256-262): a
    helical ramp with vertical loop closures between consecutive floors,
    interleaved with the odometry.  Returns (gt_poses [n,6], edges) with
    edges (i, j, z[6] axis-angle relative pose)."""
    rng = np.random.default_rng(seed)
    n = n_loops * per_loop
    gt = []
    for k in range(n):
        th = 2 * np.pi * (k % per_loop) / per_loop
        pos = np.array([radius * np.cos(th), radius * np.sin(th),
                        climb * k])
        gt.append(np.concatenate([pos, [0.0, 0.0, th + np.pi / 2]]))
    gt = np.array(gt)

    pairs = []
    for k in range(1, n):
        pairs.append((k - 1, k))
        if k >= per_loop and k % 10 == 0:
            pairs.append((k - per_loop, k))
    idx = np.array(pairs)
    rel = _se3_relative(gt[idx[:, 0]], gt[idx[:, 1]])
    edges = []
    for (i, j), z in zip(pairs, rel):
        z = z.copy()
        z[:3] += rng.normal(0, trans_noise, 3)
        z[3:] += rng.normal(0, rot_noise, 3)
        edges.append((i, j, z))
    return gt, edges


def write_g2o_3d_axisangle(path, edges, info_scale=100.0):
    """EDGE3:AXISANGLE dialect writer (identity*scale information)."""
    info = np.eye(6) * info_scale
    with open(path, "w") as f:
        for (i, j, z) in edges:
            up = " ".join(f"{info[a][b]:.1f}"
                          for a in range(6) for b in range(a, 6))
            zs = " ".join(f"{v:.9f}" for v in z)
            f.write(f"EDGE3:AXISANGLE {i} {j} {zs} {up}\n")


def fill_system(system, vertices, edges):
    """Add (id, type, state) vertices and (type, ids, z, info) edges to a
    GraphSystem (the port's or the JAX package's: the same API)."""
    for vid, tname, state in vertices:
        system.add_vertex(vid, tname, state)
    for ename, ids, z, info in edges:
        system.add_edge(ename, ids, z, info)
    return system


def make_sim3_chain(n=12, seed=44):
    """A noisy chain of n cam_sim3 vertices with a loop closure between the
    first and the last (the JAX package's Sim(3) pose-graph test scene,
    tests/test_model_families.py:80-117): each step [1, 0.1, 0, 0.02, 0.03,
    0.1] with scale 1.01, measurements with 0.01 translation noise and
    information 100 I, every vertex but the first 0.05 off.  Built with the
    port's sim3 in float64 on the CPU.  Returns (vertices, edges)."""
    import torch
    from slam_plus_plus_tpu_torch.manifolds import sim3

    rng = np.random.default_rng(seed)
    step = torch.tensor([1.0, 0.1, 0.0, 0.02, 0.03, 0.1, 1.01], dtype=torch.float64)
    gt = [torch.tensor([0.0, 0, 0, 0, 0, 0, 1.0], dtype=torch.float64)]
    for _ in range(1, n):
        gt.append(sim3.compose(gt[-1], step))
    intr = [500.0, 500.0, 320.0, 240.0, 0.0]
    vertices = [(i, "cam_sim3", np.concatenate(
        [gt[i].numpy() + (rng.normal(0, 0.05, 7) if i else 0.0), intr])) for i in range(n)]
    edges = []
    for i, j in [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]:
        z = sim3.relative_to(gt[i], gt[j]).numpy()
        z[:3] += rng.normal(0, 0.01, 3)
        edges.append(("edge_pose_cam_sim3", (i, j), z, np.eye(7) * 100.0))
    return vertices, edges


def make_sim3_invdist_ba(n_cams=3, n_points=20, n_obs=3, seed=55):
    """Inverse-distance Sim(3) BA (the shape of the JAX package's test,
    tests/test_model_families.py:120-158): cam_sim3 cameras 0.3 apart along
    x, points 4..7 in front, each an inv_dist4 owned by its nearest camera,
    which sees it through an LS edge (edge_p2c_invdist_ls), and seen by the
    n_obs - 1 cameras next to it through LO edges (edge_p2c_invdist_lo);
    0.3 px noise, unit information.  The inverse distances start 10% off,
    the cameras but the first 0.01 off in each Sim(3) parameter.  Returns
    (vertices, edges)."""
    import torch
    from slam_plus_plus_tpu_torch.manifolds import sim3
    from slam_plus_plus_tpu_torch.models.sim3_types import _project_sim3

    rng = np.random.default_rng(seed)
    gt = np.zeros((n_cams, 12))
    gt[:, 0] = -0.3 * np.arange(n_cams)
    gt[:, 3:6] = rng.normal(0, 0.01, (n_cams, 3))
    gt[:, 6] = 1.0
    gt[:, 7:] = [500.0, 500.0, 320.0, 240.0, 0.0]
    span = 0.3 * (n_cams - 1)
    pts = np.stack([rng.uniform(-0.5, span + 0.5, n_points), rng.uniform(-1, 1, n_points),
                    rng.uniform(4, 7, n_points)], axis=1)
    owner = np.clip(np.rint(pts[:, 0] / 0.3), 0, n_cams - 1).astype(np.int64)
    # n_obs consecutive cameras around the owner, the owner among them
    first = np.clip(owner - (n_obs - 1) // 2, 0, n_cams - n_obs)
    obs_cam = first[:, None] + np.arange(n_obs)
    t = torch.from_numpy
    x_own = sim3.transform_point(t(gt[owner, :7]), t(pts)).numpy()
    d = np.linalg.norm(x_own, axis=1)
    q = (1.0 / d) * (1 + rng.normal(0, 0.1, n_points))
    pid = np.repeat(np.arange(n_points), n_obs)
    cid = obs_cam.reshape(-1)
    uv = _project_sim3(t(gt[cid]), t(pts[pid])).numpy() + rng.normal(0, 0.3, (len(pid), 2))
    init = gt.copy()
    init[1:, :7] += rng.normal(0, 0.01, (n_cams - 1, 7))
    vertices = [(c, "cam_sim3", init[c]) for c in range(n_cams)]
    vertices += [(n_cams + p, "inv_dist4", np.concatenate([x_own[p] / d[p], [q[p]]]))
                 for p in range(n_points)]
    edges = []
    for e, (p, c) in enumerate(zip(pid.tolist(), cid.tolist())):
        o = int(owner[p])
        if c == o:
            edges.append(("edge_p2c_invdist_ls", (o, n_cams + p), uv[e], np.eye(2)))
        else:
            edges.append(("edge_p2c_invdist_lo", (o, c, n_cams + p), uv[e], np.eye(2)))
    return vertices, edges
