"""The port's C++ g2o reader (io/native_parser.py) against the port's Python
parser and the JAX package's native reader, on the CPU.

Against the Python parser the systems must be equal exactly: the vertex
order, the edge insertion log (FastL's replay order), every store bitwise
(the camera pose inversion runs the Python parser's own scalar code) and
the parse counts.  Against the JAX package's reader, whose vectorized
camera inversion may round differently, vertex states are held at 1e-14
absolute (tests/test_native_parser.py's bound) and everything else
exactly.  Files: the JAX test's five families, stereo, intrinsics,
spheron and marker files, a BA file with a point declared again after its
edges, a file of comments, one with a token neither parser reads, and one
with the ternary SE(3) hyperedge, which the C++ reader lacks: that one
must raise.
"""

import numpy as np
import pytest

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.io.native_parser import parse_g2o_fast as jparse_fast
from slam_plus_plus_tpu_torch.app.incremental_ba import write_incremental_ba
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io import native_parser
from slam_plus_plus_tpu_torch.io.native_parser import TOKENS, parse_g2o_fast, read_records
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.ops import _build

_INFO6 = " ".join(["20 0 0 0 0 0 20 0 0 0 0 20 0 0 0 20 0 0 20 0 20"])


def _write(family, p):
    if family == "man":
        poses, edges = D.make_manhattan_2d(n_poses=120, seed=50)
        D.write_g2o_2d(p, edges, poses)
    elif family == "lm":
        _gp, _gl, pe, le = D.make_landmark_2d(n_poses=60, n_landmarks=25, seed=51)
        D.write_g2o_landmark_2d(p, pe, le)
    elif family == "ba":
        D.write_g2o_ba(p, *D.make_ba_scene(n_cams=6, n_points=80, seed=52))
    elif family == "sphere":
        poses, edges = D.make_sphere_3d(n_poses=60, seed=53)
        D.write_g2o_3d(p, edges, poses)
    elif family == "rocv":
        D.write_g2o_rocv(p, *D.make_rocv_scene(n_steps=40, seed=54))
    elif family == "stereo":
        cams, pts, _obs = D.make_ba_scene(n_cams=6, n_points=80, seed=55)
        D.write_g2o_ba_stereo(p, cams, pts, D.make_ba_stereo_obs(cams, pts, seed=56))
    elif family == "intrinsics":
        D.write_g2o_ba_intrinsics(p, *D.make_ba_scene(n_cams=6, n_points=80, seed=57))
    elif family == "spheron":
        D.write_g2o_spheron(p, *D.make_spheron_scene(n_poses=8, n_points=60, seed=58))
    elif family == "markers":
        write_incremental_ba(p, *D.make_ba_scene(n_cams=6, n_points=60, seed=59),
                             cams_per_chunk=2)
    elif family == "redeclared":
        D.write_g2o_ba(p, *D.make_ba_scene(n_cams=4, n_points=30, seed=60))
        with open(p, "a") as f:
            f.write("VERTEX_XYZ 7 0.25 -0.5 6.125\n# a comment\n")
    elif family == "comments_only":
        with open(p, "w") as f:
            f.write("# no edges\n\n% nor vertices\n")
    elif family == "neither_reads":
        poses, edges = D.make_manhattan_2d(n_poses=40, seed=61)
        D.write_g2o_2d(p, edges, poses)
        with open(p, "a") as f:
            f.write("VERTEX:SIM3 3 0 0 0 0 0 0 1\nFIX 0\n")


FAMILIES = ("man", "lm", "ba", "sphere", "rocv", "stereo", "intrinsics", "spheron",
            "markers", "redeclared", "comments_only", "neither_reads")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_parser")
    out = {}
    for family in FAMILIES:
        out[family] = str(d / f"{family}.g2o")
        _write(family, out[family])
    return out


def _same(a, b, state_atol=0.0):
    assert a.vertex_order == b.vertex_order
    assert a._edge_insert_log == b._edge_insert_log
    assert a.vertex_directory == b.vertex_directory
    assert set(a.vertex_stores) == set(b.vertex_stores)
    assert set(a.edge_stores) == set(b.edge_stores)
    for t, sa in a.vertex_stores.items():
        sb = b.vertex_stores[t]
        assert sa.n == sb.n and list(sa.global_ids) == list(sb.global_ids)
        np.testing.assert_allclose(sa.data, sb.data, rtol=0, atol=state_atol)
    for t, ea in a.edge_stores.items():
        eb = b.edge_stores[t]
        assert ea.n == eb.n
        for f in ("vertex_ids", "measurements", "informations"):
            assert np.array_equal(getattr(ea, f)[:ea.n], getattr(eb, f)[:eb.n]), (t, f)


@pytest.mark.parametrize("family", FAMILIES)
def test_equals_python_parser(files, family):
    want = parse_g2o(files[family])
    got = parse_g2o_fast(files[family])
    _same(got, want)
    for k in ("lines", "vertices", "edges", "markers", "unknown_tokens"):
        assert getattr(got.parse_stats, k) == getattr(want.parse_stats, k), k
    if family == "redeclared":
        assert np.array_equal(got.vertex_state(7), [0.25, -0.5, 6.125])
    if family == "neither_reads":
        assert got.parse_stats.unknown_tokens == {"VERTEX:SIM3": 1, "FIX": 1}


@pytest.mark.parametrize("family", ("man", "lm", "ba", "sphere", "rocv", "stereo",
                                    "intrinsics", "spheron"))
def test_equals_jax_native_reader(files, family):
    _same(parse_g2o_fast(files[family]), jparse_fast(files[family]), state_atol=1e-14)


def test_token_the_cxx_reader_lacks_raises(tmp_path):
    """EDGE3:TERNARY is read by the Python parser and not by the C++
    reader (the JAX binding returns a graph without those edges)."""
    p = str(tmp_path / "ternary.g2o")
    with open(p, "w") as f:
        for i in range(4):
            f.write(f"EDGE3:AXISANGLE {i} {i + 1} 1 0 0 0 0 0.1 {_INFO6}\n")
        f.write(f"EDGE3:TERNARY 0 1 2 0.1 0 0 0 0.02 0 {_INFO6}\n")
    assert "edge_pose3d_ternary" in parse_g2o(p).edge_stores
    assert "edge_pose3d_ternary" not in jparse_fast(p).edge_stores
    with pytest.raises(ValueError, match=r"EDGE3:TERNARY \(1 lines\)"):
        parse_g2o_fast(p)


def test_token_table_matches_the_cxx_reader(tmp_path):
    """Every token of TOKENS reaches the C++ reader as its kind, with its
    ids, and nothing is counted unknown."""
    p = str(tmp_path / "tokens.g2o")
    with open(p, "w") as f:
        for tok in TOKENS:
            f.write(f"{tok.lower()} 5 6 7 " + " ".join(["0.5"] * 30) + "\n")
    records, values, stats = read_records(p)
    assert stats == {"lines": len(TOKENS), "unknown": 0, "truncated": 0}
    assert records[:, 0].tolist() == [k for k, _ in TOKENS.values()]
    for rec, (_k, n_ids) in zip(records, TOKENS.values()):
        assert rec[1:1 + n_ids].tolist() == [5, 6, 7][:n_ids]
        assert rec[4] == 30 + 3 - n_ids


def test_missing_compiler_raises(tmp_path, monkeypatch, files):
    """No fallback: without the compiler the parse raises, naming it."""
    monkeypatch.setattr(_build, "CXX", "no-such-g++")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    native_parser._lib.cache_clear()
    _build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+ not found"):
            parse_g2o_fast(files["man"])
    finally:
        native_parser._lib.cache_clear()
        _build.load_host.cache_clear()


def test_bulk_insertion_equals_one_at_a_time():
    """Past the stores' first capacity of 16, in two batches each."""
    rng = np.random.default_rng(3)
    states = rng.normal(size=(40, 3))
    ids = (rng.permutation(40) + 2).tolist()
    edges = np.stack([rng.integers(0, 2, 50), rng.choice(ids, 50)], axis=1)
    z, info = rng.normal(size=(50, 2)), np.tile(np.eye(2), (50, 1, 1))
    cams = rng.normal(size=(2, 11))
    bulk, one = GraphSystem(), GraphSystem()
    for s in (bulk, one):
        for gid, cam in enumerate(cams):
            s.add_vertex(gid, "cam", cam)
    bulk.bulk_add_vertices("xyz", ids[:10], states[:10])
    bulk.bulk_add_vertices("xyz", ids[10:], states[10:])
    bulk.bulk_add_edges("edge_p2c", edges[:20], z[:20], info[:20])
    bulk.bulk_add_edges("edge_p2c", edges[20:], z[20:], info[20:])
    for gid, st in zip(ids, states):
        one.add_vertex(gid, "xyz", st)
    for e, zz, ii in zip(edges, z, info):
        one.add_edge("edge_p2c", e, zz, ii)
    _same(bulk, one)
