"""The benchmark's scene generators are faithful copies of the port's, at
the acceptance rows' settings, and the files they write read back as
``as_read`` says."""

from __future__ import annotations

import numpy as np

from benchmark.scenes import ba_large, g2o, manhattan_2d

MANHATTAN = dict(n_poses=3500, step=1.0, trans_noise=0.05, rot_noise=0.02, loop_prob=0.3,
                 loop_radius=2.0)
VENICE_REAL = dict(n_cams=871, n_points=100000, obs_per_point=8, noise_px=0.5,
                   point_noise=0.05, f=500.0, cx=320.0, cy=240.0)


def test_manhattan_is_the_ports():
    from slam_plus_plus_tpu_torch.io.datasets import make_manhattan_2d

    poses, edges = make_manhattan_2d(n_poses=3500, seed=101, loop_prob=0.3)
    s = manhattan_2d.faithful(MANHATTAN, 101)
    assert np.array_equal(s.poses, poses)
    edges = sorted(edges, key=lambda e: max(e[0], e[1]))     # write_g2o_2d's order
    assert s.n_edges == len(edges)
    assert np.array_equal(s.edge_i, [e[0] for e in edges])
    assert np.array_equal(s.edge_j, [e[1] for e in edges])
    assert np.array_equal(s.z, np.array([e[2] for e in edges]))
    assert np.array_equal(s.info, np.array([e[3] for e in edges]))


def test_venice_is_the_ports():
    from slam_plus_plus_tpu_torch.io.datasets import make_ba_scene_large

    cams, points, obs = make_ba_scene_large(n_cams=871, n_points=100000, obs_per_point=8,
                                            seed=871)
    s = ba_large.generate(VENICE_REAL, 871, noise_seed=1)
    assert np.array_equal(s.points, points)
    assert np.array_equal(s.cam_pos, np.array([c[0] for c in cams]))
    assert np.array_equal(s.cam_quat, np.array([c[1] for c in cams]))
    assert np.array_equal(s.intrinsics, np.array([c[2:] for c in cams]))
    ob = np.array(obs)
    assert np.array_equal(s.obs_point, ob[:, 0].astype(int))
    assert np.array_equal(s.obs_cam, ob[:, 1].astype(int))
    assert np.array_equal(s.obs_uv, ob[:, 2:])
    # write_g2o_ba's initial points: seed 1, one draw of 3 per point
    rng = np.random.default_rng(1)
    assert np.array_equal(s.points_init, points + rng.normal(0, 0.05, points.shape))


def test_files_read_back_as_read(tmp_path):
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o

    s = ba_large.generate(dict(VENICE_REAL, n_cams=30, n_points=200, obs_per_point=3), 7)
    path = str(tmp_path / "ba.g2o")
    s.write(path)
    r = s.as_read()
    for system in (parse_g2o_fast(path), parse_g2o(path)):
        assert np.array_equal(system.vertex_stores["xyz"].data, r.points_init)
        st = system.edge_stores["edge_p2c"]
        assert np.array_equal(st.measurements[:st.n], r.obs_uv)
        assert np.array_equal(st.vertex_ids[:st.n, 0], r.obs_cam)
    p = manhattan_2d.generate(dict(MANHATTAN, n_poses=200, closures=80, structure_seed=101), 7)
    path = str(tmp_path / "pose.g2o")
    p.write(path)
    r = p.as_read()
    system = parse_g2o_fast(path)
    st = system.edge_stores["edge_pose2d"]
    assert np.array_equal(st.measurements[:st.n], r.z)
    assert np.array_equal(st.informations[:st.n], r.info)
    assert np.array_equal(st.vertex_ids[:st.n], np.stack([p.edge_i, p.edge_j], 1))


def test_seeds_share_the_graph():
    params = dict(MANHATTAN, n_poses=300, closures=167, structure_seed=101)
    a, b = manhattan_2d.generate(params, 1), manhattan_2d.generate(params, 2)
    f = manhattan_2d.faithful(params, 101)
    assert np.array_equal(a.poses, f.poses)                  # the port's walk
    assert np.array_equal(a.edge_i, b.edge_i) and np.array_equal(a.edge_j, b.edge_j)
    assert not np.array_equal(a.z, b.z)
    # the odometry chain and exactly `closures` distinct closures, each
    # within the radius and more than five steps back, in stream order
    odo = a.edge_j - a.edge_i == 1
    assert odo.sum() == 299 and (~odo).sum() == 167
    assert len({(i, j) for i, j in zip(a.edge_i, a.edge_j)}) == a.n_edges
    gap = np.linalg.norm(a.poses[a.edge_j[~odo], :2] - a.poses[a.edge_i[~odo], :2], axis=1)
    assert (gap < 2.0).all() and (a.edge_j[~odo] - a.edge_i[~odo] > 5).all()
    assert (np.diff(a.edge_j) >= 0).all()
    # the noise is of the generator's size
    c, sn = np.cos(a.poses[a.edge_i, 2]), np.sin(a.poses[a.edge_i, 2])
    d = a.poses[a.edge_j] - a.poses[a.edge_i]
    true = np.stack([c * d[:, 0] + sn * d[:, 1], -sn * d[:, 0] + c * d[:, 1], d[:, 2]], 1)
    e = a.z - true
    e[:, 2] = np.arctan2(np.sin(e[:, 2]), np.cos(e[:, 2]))
    assert np.abs(e).max() < 10 * 0.05


def test_fixed_point_text():
    x = np.array([0.0, -0.0, 1.5, -2.25e-11, 639.99999999996, -1234.0000000001])
    import io

    f = io.BytesIO()
    g2o.write_lines(f, "T", np.array([[7], [12], [0], [3], [99], [1000]]), x[:, None])
    lines = f.getvalue().decode().splitlines()
    assert [float(l.split()[2]) for l in lines] == g2o.as_read(x).tolist()
    assert [int(l.split()[1]) for l in lines] == [7, 12, 0, 3, 99, 1000]
