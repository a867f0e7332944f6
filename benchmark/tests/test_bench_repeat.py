"""Restoring the initial estimate and solving again on the same solver
reads the same states and chi2 as the first solve."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import drivers, scenes
from benchmark.run import CACHE
from benchmark.spec import Spec
from benchmark.tests.small import SEED, force_block_cholesky, small_spec

CELLS = [w["name"] for w in Spec().data["workloads"]]


def _driver(spec, cell, device):
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast

    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    scene = scenes.generate(cfg, SEED)
    system = parse_g2o_fast(scenes.scene_file(cfg, scene, SEED, CACHE))
    return drivers.build(system, scene, cfg, traffic, device), spec.limits(cell), cfg


def _repeat(spec, cell, device):
    d, limits, cfg = _driver(spec, cell, device)
    d.unit()
    first = d.answer()
    d.unit()
    second = d.answer()
    return first, second, limits, cfg


def _assert_same(first, second):
    assert first["chi2"] == second["chi2"]
    for k in first:
        assert np.array_equal(np.asarray(first[k]), np.asarray(second[k])), k


@pytest.mark.parametrize("cell", CELLS)
def test_repeat_on_cpu(tmp_path, cell):
    _assert_same(*_repeat(small_spec(tmp_path), cell, "cpu")[:2])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_repeat_on_the_card(tmp_path, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    first, second, limits, cfg = _repeat(small_spec(tmp_path), cell, "cuda")
    if cfg["dtype"] == "float64":
        _assert_same(first, second)       # fixed-order float64 sums (F3)
        return
    # float32 sums by atomics may round apart: the repeat stays far inside
    # the limits the reference is held to
    assert abs(first["chi2"] - second["chi2"]) <= 0.1 * limits["chi2_rel"]["limit"] * first["chi2"]
    assert np.abs(first["cam"] - second["cam"]).max() <= 0.1 * limits["cam_t_gap"]["limit"]
    assert np.abs(first["xyz"] - second["xyz"]).max() <= 0.1 * limits["point_gap"]["limit"]


def test_repeat_on_the_block_cholesky_route_on_cpu(tmp_path, monkeypatch):
    """The GN cell at test size on its full-size route."""
    force_block_cholesky(monkeypatch)
    first, second, _, _ = _repeat(small_spec(tmp_path), "manhattan3500.batch", "cpu")
    _assert_same(first, second)


@pytest.mark.card
def test_repeat_on_the_block_cholesky_route_on_the_card(tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    force_block_cholesky(monkeypatch)
    first, second, _, _ = _repeat(small_spec(tmp_path), "manhattan3500.batch", "cuda")
    _assert_same(first, second)           # fixed-order float64 sums (F3)
