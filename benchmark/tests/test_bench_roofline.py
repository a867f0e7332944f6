"""K1's least time: the P2C stage's bytes and operations, counted over the
real observations."""

from __future__ import annotations

import pytest

from benchmark import drivers, roofline


def test_bench_shape_bound():
    """PERF.md's K1 bound at the bench shape: E = 608,000, float32, bytes at
    3.35 TB/s: 0.0682 ms (float64 0.1365)."""
    for itemsize, ms in ((4, 0.0682), (8, 0.1365)):
        nbytes, flops = roofline.p2c_work(608000, itemsize)
        t, by = roofline.least_seconds(nbytes, flops, itemsize)
        assert by == "bytes"
        assert t * 1e3 == pytest.approx(ms, abs=5e-5)


def test_counts_real_observations(tmp_path):
    """The bench scene's uneven degrees pad the uniform layout; the count
    the reader takes is of observations, not slots."""
    from slam_plus_plus_tpu_torch.io import datasets
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast

    cams, points, obs = datasets.make_ba_scene(n_cams=8, n_points=120, seed=3)
    path = str(tmp_path / "ba.g2o")
    datasets.write_g2o_ba(path, cams, points, obs)
    system = parse_g2o_fast(path)

    class Scene:
        n_obs = len(obs)

    d = drivers.build(system, Scene(), {"dtype": "float32"},
                      {"driver": "batch", "solver": "lm", "iterations": 1,
                       "dx_threshold": 0.01}, "cpu")
    asm = d.solver.asm
    slots = asm.Nl * asm.M
    assert asm.k1 and slots > len(obs)
    assert d.counts()["observations"] == len(obs)
    assert roofline.p2c_work(len(obs), 4)[0] < roofline.p2c_work(slots, 4)[0]
