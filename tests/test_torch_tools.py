"""Port parity for the host tools (utils/matrix_io.py, utils/flops.py,
utils/timer.py), float64 on the CPU: the MatrixMarket text of the same
lambda line for line (values to 1e-12 relative), the block-layout file
byte for byte, equal FLOP dicts, the stage timer's dump() format, and
PyTorch's FLOP count of one call."""

import importlib.util
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.utils import flops as jflops
from slam_plus_plus_tpu.utils import matrix_io as jio
from slam_plus_plus_tpu.utils.timer import StageTimer as JTimer
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.bsr import block_system_to_scipy
from slam_plus_plus_tpu_torch.utils import flops as tflops
from slam_plus_plus_tpu_torch.utils import matrix_io as tio
from slam_plus_plus_tpu_torch.utils.timer import StageTimer as TTimer


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """manhattan 40 (the JAX test's), a small mono BA scene (the uniform
    layout in both packages) and a small 2D landmark graph, whose flat
    layout the JAX package takes under edge_layout="flat" (ROADMAP.md
    Queue 1, item 11)."""
    d = tmp_path_factory.mktemp("tools")
    paths = {"manhattan": str(d / "m.g2o"), "ba": str(d / "ba.g2o"),
             "landmark": str(d / "l.g2o")}
    poses, edges = jds.make_manhattan_2d(n_poses=40, seed=90)
    jds.write_g2o_2d(paths["manhattan"], edges, poses)
    jds.write_g2o_ba(paths["ba"], *jds.make_ba_scene(n_cams=5, n_points=60, seed=12))
    _gp, _gl, pe, le = jds.make_landmark_2d(n_poses=30, n_landmarks=12, seed=13)
    jds.write_g2o_landmark_2d(paths["landmark"], pe, le)
    out = {}
    for name, p in paths.items():
        js, ts = jparse(p), tparse(p)
        cfg = SolverConfig(edge_layout="flat") if name == "landmark" else None
        ja, ta = JAssembler(js, cfg), TAssembler(ts, device="cpu")
        out[name] = (ja, ja.assemble(ja.snapshot_states(js)),
                     ta, ta.assemble(ta.snapshot_states(ts)))
    return out


NAMES = ["manhattan", "ba", "landmark"]


@pytest.mark.parametrize("name", NAMES)
def test_matrix_market_text_matches_jax(systems, name, tmp_path):
    ja, jbs, ta, tbs = systems[name]
    jp, tp = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    jio.save_matrix_market(jp, ja, jbs)
    tio.save_matrix_market(tp, ta, tbs)
    jl, tl = open(jp).read().splitlines(), open(tp).read().splitlines()
    assert tl[:3] == jl[:3] and len(tl) == len(jl)
    scale = max(abs(float(ln.split()[2])) for ln in jl[3:])
    for a, b in zip(tl[3:], jl[3:]):
        ra, ca, va = a.split()
        rb, cb, vb = b.split()
        assert (ra, ca) == (rb, cb)
        assert abs(float(va) - float(vb)) <= 1e-12 * max(abs(float(vb)), 1e-300) or \
            abs(float(va) - float(vb)) <= 1e-15 * scale
    A = sio.mmread(tp).toarray()
    A = np.triu(A) + np.triu(A, 1).T
    assert np.array_equal(A, block_system_to_scipy(ta, tbs).toarray())


@pytest.mark.parametrize("name", NAMES)
def test_block_layout_byte_equal(systems, name, tmp_path):
    ja, _jbs, ta, _tbs = systems[name]
    jp, tp = str(tmp_path / "j.bla"), str(tmp_path / "t.bla")
    jio.save_block_layout(jp, ja)
    tio.save_block_layout(tp, ta)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert os.path.getsize(tp) > 0


def test_rasterize_sparsity_without_matplotlib(systems, tmp_path):
    ja, jbs, ta, tbs = systems["landmark"]
    got = tio.rasterize_sparsity(str(tmp_path / "t.png"), ta)
    want = jio.rasterize_sparsity(str(tmp_path / "j.png"), ja, jbs)
    if importlib.util.find_spec("matplotlib") is None:
        assert got is None and want is None
    else:
        assert os.path.getsize(got) > 0 and os.path.getsize(want) > 0


@pytest.mark.parametrize("name", NAMES)
def test_flop_dicts_equal(systems, name):
    ja, _jbs, ta, _tbs = systems[name]
    assert tflops.assembly_flops(ta) == jflops.assembly_flops(ja)
    assert tflops.schur_flops(ta) == jflops.schur_flops(ja)
    assert tflops.assembly_flops(ta)["total"] > 0


def test_torch_cost_counts_matrix_products():
    a = torch.zeros((64, 32), dtype=torch.float64)
    b = torch.zeros((32, 16), dtype=torch.float64)
    assert tflops.torch_cost(torch.mm, a, b) == {"flops": 2.0 * 64 * 32 * 16}
    assert tflops.torch_cost(torch.add, a, a) == {"flops": 0.0}
    with pytest.raises(RuntimeError):           # no swallowed exception
        tflops.torch_cost(torch.mm, a, a)


def test_stage_timer_matches_jax():
    j, t = JTimer(), TTimer()
    for timer in (j, t):
        for name in ("a", "a", "b"):
            with timer.stage(name):
                pass
        assert timer.counts == {"a": 2, "b": 1}
        timer.totals.update({"a": 0.25, "b": 0.5, "chol": 1.25})
        timer.counts["chol"] = 3
    assert t.dump() == j.dump()
    assert t.dump(total=4.0) == j.dump(total=4.0)
    assert t.dump().splitlines()[0] == "\t    chol: 1.250000 (62.5%) x3"
    cpu = TTimer(device="cpu")
    with cpu.stage("x"):
        torch.ones(3).sum()
    assert cpu.counts["x"] == 1 and cpu.totals["x"] >= 0.0
