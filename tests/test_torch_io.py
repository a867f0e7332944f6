"""Port parity: BA host input.  The same file through both parsers gives
equal stores; the same seed through both generators gives the same bytes;
tokens of unported families raise instead of being skipped."""

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


@pytest.mark.parametrize("line, item", [
    ("EDGE_SE2 0 1 1.0 0.0 0.0 1 0 0 1 0 1", "item 15"),
    ("VERTEX_SCAM 0 0 0 0 0 0 0 1 500 500 320 240 0 0.1", "item 10"),
    ("EDGE_PROJECT_P2MCI 9 0 10 320.0 240.0 1 0 1", "item 10"),
    ("ROCV:RANGE 0 1 2.5 1", "item 16"),
])
def test_unported_token_raises(tmp_path, line, item):
    p = tmp_path / "x.g2o"
    p.write_text("VERTEX_CAM 0 0 0 0 0 0 0 1 500 500 320 240 0\n" + line + "\n")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        tparse(str(p))


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
