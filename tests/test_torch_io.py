"""Port parity: host input.  The same file through both parsers gives equal
stores and counts (BA, every SE(2)/SE(3)/landmark and ROCV token, and the
Sim(3) tokens that both count as unknown); the same seed through both
generators gives the same bytes."""

import numpy as np
import pytest

from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu_torch.io import datasets as tds
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.io.parser import peek_dataset as tpeek


@pytest.fixture(scope="module")
def ba_file(tmp_path_factory):
    cams, pts, obs = jds.make_ba_scene(n_cams=7, n_points=90, seed=21)
    p = str(tmp_path_factory.mktemp("io") / "ba.g2o")
    jds.write_g2o_ba(p, cams, pts, obs)
    return p


def _assert_same_system(js, ts):
    assert sorted(js.vertex_stores) == sorted(ts.vertex_stores)
    for t in js.vertex_stores:
        assert np.array_equal(js.vertex_stores[t].data, ts.vertex_stores[t].data), t
        assert js.vertex_stores[t].global_ids == ts.vertex_stores[t].global_ids
    assert js.vertex_order == ts.vertex_order
    assert js.vertex_directory == ts.vertex_directory
    assert js._edge_insert_log == ts._edge_insert_log
    assert sorted(js.edge_stores) == sorted(ts.edge_stores)
    for name, je in js.edge_stores.items():
        te = ts.edge_stores[name]
        assert je.n == te.n > 0, name
        for f in ("vertex_ids", "measurements", "informations"):
            assert np.array_equal(getattr(je, f)[:je.n], getattr(te, f)[:te.n]), (name, f)
    assert js.parse_stats.vertices == ts.parse_stats.vertices
    assert js.parse_stats.edges == ts.parse_stats.edges
    assert js.parse_stats.unknown_tokens == ts.parse_stats.unknown_tokens


def test_parsers_agree(ba_file):
    js, ts = jparse(ba_file), tparse(ba_file)
    assert sorted(js.vertex_stores) == sorted(ts.vertex_stores) == ["cam", "xyz"]
    for t in js.vertex_stores:
        assert np.array_equal(js.vertex_stores[t].data, ts.vertex_stores[t].data), t
        assert js.vertex_stores[t].global_ids == ts.vertex_stores[t].global_ids
    assert js.vertex_order == ts.vertex_order
    assert js.vertex_directory == ts.vertex_directory
    assert js._edge_insert_log == ts._edge_insert_log
    je, te = js.edge_stores["edge_p2c"], ts.edge_stores["edge_p2c"]
    assert je.n == te.n > 0
    for f in ("vertex_ids", "measurements", "informations"):
        assert np.array_equal(getattr(je, f)[:je.n], getattr(te, f)[:te.n]), f


def test_generator_is_byte_identical(tmp_path):
    jp, tp = tmp_path / "j.g2o", tmp_path / "t.g2o"
    jds.write_g2o_ba(str(jp), *jds.make_ba_scene(n_cams=6, n_points=70, seed=8))
    tds.write_g2o_ba(str(tp), *tds.make_ba_scene(n_cams=6, n_points=70, seed=8))
    assert jp.read_bytes() == tp.read_bytes()


_INFO3 = "100 1 2 200 3 400"
_INFO6 = " ".join(str(v) for v in (50, 1, 0, 0, 0, 2, 60, 0, 0, 3, 0, 70, 0, 0, 0,
                                   800, 4, 0, 900, 0, 990))

#: one small file per new token (and alias), each edge reaching new vertices
#: through the edge type's initializer and ignored vertex lines around it
NEW_TOKENS = {
    "EDGE2": f"VERTEX2 0 1 2 0.5\nEDGE2 0 1 1.0 0.2 0.3 {_INFO3}\nEDGE2 1 2 -0.5 1.0 -3.0 {_INFO3}",
    "EDGE_SE2": f"VERTEX_SE2 0 0 0 0\nEDGE_SE2 0 1 1.0 0.2 0.3 {_INFO3}",
    "EDGE": f"EDGE 0 1 1.0 0.2 3.1 {_INFO3}\nVERTEX 1 5 5 5",
    "ODOMETRY": f"ODOMETRY 0 1 1.0 0.2 0.3 {_INFO3}",
    "LANDMARK2:XY": f"EDGE2 0 1 1.0 0 0.3 {_INFO3}\nLANDMARK2:XY 1 2 2.0 -1.5 1 0 1\n"
                    "LANDMARK2:XY 0 2 2.5 -1.0 1 0 1",
    "EDGE_SE2_XY": f"EDGE_SE2 0 1 1 0 0 {_INFO3}\nEDGE_SE2_XY 1 2 0.5 0.5 1 0 1",
    "LANDMARK": "LANDMARK 0 1 3.0 4.0 1 0 1",
    "EDGE_BEARING_SE2_XY": "EDGE_BEARING_SE2_XY 0 1 -3.0 4.0 1 0 1",
    "LANDMARK2:RB": f"EDGE2 0 1 1 0 0 {_INFO3}\nLANDMARK2:RB 1 2 2.0 0.7 10 1 20",
    "EDGE_SE2_RB": "EDGE_SE2_RB 0 1 2.0 -2.7 10 1 20",
    "EDGE_BEARING_SE2_RB": "EDGE_BEARING_SE2_RB 0 1 2.0 3.0 10 1 20",
    "EDGE3": f"VERTEX3 0 1 2 3 0.1 0.2 0.3\nEDGE3 0 1 1 2 3 0.1 -0.2 2.9 {_INFO6}\n"
             f"EDGE3 1 2 0 1 0 3.1 0.0 -0.4 {_INFO6}",
    "EDGE_SE3": f"VERTEX_SE3 0 0 0 0 0 0 0\nEDGE_SE3 0 1 1 2 3 0.5 1.2 -2.0 {_INFO6}",
    "EDGE3:AXISANGLE": f"EDGE3:AXISANGLE 0 1 1 2 3 0.1 -0.2 0.3 {_INFO6}\n"
                       f"EDGE3:AXISANGLE 1 2 0 0 1 2.0 2.0 0.0 {_INFO6}",
    "EDGE_SE3:AXISANGLE": f"EDGE_SE3:AXISANGLE 0 1 1 2 3 0 0 1e-14 {_INFO6}",
    "EDGE3:TERNARY": f"EDGE3:AXISANGLE 0 1 1 0 0 0 0 0.1 {_INFO6}\n"
                     f"EDGE3:TERNARY 0 1 2 0.1 0 0 0 0.02 0 {_INFO6}",
    "EDGE_SE3_TERNARY": f"EDGE_SE3_TERNARY 0 1 2 0.1 0.2 0 0.01 0.02 0 {_INFO6}",
    "LANDMARK3:XYZ": f"EDGE3:AXISANGLE 0 1 1 0 0 0 0 0.5 {_INFO6}\n"
                     f"LANDMARK3:XYZ 1 2 2 1 0.5 {_INFO3}\nVERTEX_XYZ 2 9 9 9",
    "EDGE_SE3_XYZ": f"EDGE_SE3_XYZ 0 1 -2 1 0.5 {_INFO3}",
    "ROCV:RECEIVER": "ROCV:RECEIVER 0 1 2 3 0.1 0.2 0.3\nROCV:RECEIVER 1 1.1 2.1 3 0.1 0.2 0.3",
    "ROCV:RECEIVER_GTFAKE": "ROCV:RECEIVER_GTFAKE 3 1 2 3 0.1 0.2 0.3",
    "ROCV:TRANSMITTER": "ROCV:TRANSMITTER 5 1 2 3 0 0 0",
    "ROCV:TRANSMITTER_UF": "ROCV:TRANSMITTER 5 1 2 3 0 0 0\n"
                           "ROCV:TRANSMITTER_UF 5 1000 1 2 1000 3 1000",
    "ROCV:DELTA_TIME": f"ROCV:RECEIVER 0 1 2 3 0.1 0.2 0.3\nROCV:DELTA_TIME 0 1 0.5 {_INFO6}\n"
                       f"ROCV:DELTA_TIME 1 2 0.25 {_INFO6}",
    "ROCV:RANGE": "ROCV:RECEIVER 0 1 2 3 0.1 0.2 0.3\nROCV:TRANSMITTER 5 4 -2 1 0 0 0\n"
                  "ROCV:RANGE 0 5 3.2 2500",
    # the JAX parser dispatches no Sim(3) token: counted as unknown
    "VERTEX_CAM:SIM3": "VERTEX_CAM:SIM3 0 0 0 0 0 0 0 1 1 500 500 320 240 0",
    "VERTEX:SIM3": "VERTEX:SIM3 0 0 0 0 0 0 0 1 1\nVERTEX:SIM3 1 0 0 0 0 0 0 1 1",
}


@pytest.mark.parametrize("token", sorted(NEW_TOKENS))
def test_parsers_agree_on_token(tmp_path, token):
    p = tmp_path / "t.g2o"
    p.write_text(NEW_TOKENS[token] + "\n")
    _assert_same_system(jparse(str(p)), tparse(str(p)))


@pytest.mark.parametrize("family", ["manhattan", "city", "sphere", "landmark"])
def test_pose_graph_generator_is_byte_identical(tmp_path, family):
    jp, tp = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    if family == "manhattan":
        for ds, p in ((jds, jp), (tds, tp)):
            poses, edges = ds.make_manhattan_2d(n_poses=150, seed=4, loop_prob=0.3)
            ds.write_g2o_2d(p, edges, poses)
    elif family == "city":
        for ds, p in ((jds, jp), (tds, tp)):
            poses, edges = ds.make_city_2d(n_poses=300, seed=6)
            ds.write_g2o_2d(p, edges, poses)
    elif family == "sphere":
        for ds, p in ((jds, jp), (tds, tp)):
            poses, edges = ds.make_sphere_3d(n_poses=80, seed=2, trans_noise=0.01,
                                             rot_noise=0.005)
            ds.write_g2o_3d(p, edges, poses)
    else:
        for ds, p in ((jds, jp), (tds, tp)):
            _gp, _gl, pe, le = ds.make_landmark_2d(n_poses=80, n_landmarks=30,
                                                   world=12.0, obs_radius=5.0, seed=9)
            ds.write_g2o_landmark_2d(p, pe, le)
    with open(jp, "rb") as fj, open(tp, "rb") as ft:
        assert fj.read() == ft.read()
    _assert_same_system(jparse(jp), tparse(jp))


def test_truncated_line_is_reported_and_skipped(tmp_path, capsys):
    p = tmp_path / "t.g2o"
    p.write_text("VERTEX_CAM 0 0 0 0 0 0 0 1 500 500 320 240 0\n"
                 "VERTEX_XYZ 1 0 0 5\n"
                 "EDGE_PROJECT_P2MC 1 0 320.0\n"
                 "EDGE_PROJECT_P2MC 1 0 320.0 240.0 1 0 1\n")
    assert tpeek(str(p))["has_ba"]
    s = tparse(str(p))
    assert "line 3: line is truncated" in capsys.readouterr().err
    assert s.edge_stores["edge_p2c"].n == 1


@pytest.mark.parametrize("kind", ["ba_markers", "pose_markers"])
def test_parser_hooks_match_jax(tmp_path, kind):
    """parse_g2o's on_marker hook runs at every CONSISTENCY_MARKER with the
    system's edge and vertex counts of the JAX parser's at each call (a
    marker BA file in camera chunks, and a pose graph with a marker after
    every 25th line)."""
    from slam_plus_plus_tpu_torch.app.incremental_ba import write_incremental_ba

    p = str(tmp_path / f"{kind}.g2o")
    if kind == "ba_markers":
        write_incremental_ba(p, *tds.make_ba_scene(n_cams=6, n_points=50, seed=4),
                             cams_per_chunk=2)
    else:
        poses, edges = tds.make_manhattan_2d(n_poses=60, seed=6)
        tds.write_g2o_2d(p, edges, poses)
        lines = open(p).read().splitlines()
        with open(p, "w") as f:
            for k, ln in enumerate(lines):
                f.write(ln + "\n" + ("CONSISTENCY_MARKER\n" if k % 25 == 24 else ""))

    def events(parse):
        seen = []
        system = parse(p, on_marker=lambda s: seen.append((s.num_edges, len(s.vertex_order))))
        return seen, system.num_edges

    want, want_edges = events(jparse)
    got, got_edges = events(tparse)
    assert got == want and got_edges == want_edges
    assert len(got) >= 3 and got[-1][0] <= got_edges
    assert all(a[0] <= b[0] for a, b in zip(got, got[1:])) and got[-1][0] > got[0][0]
