"""The benchmark cell victoria.fastl (configuration landmark-victoria-park:
Victoria Park's counts on FastL's mixed pose-landmark class), on the CPU.

The scene at full size has the published counts and one graph for every
seed; at the configuration's ``test_params`` the port's FastLSolver agrees
with the plain reference ``benchmark/reference/landmark_fastl.py`` to the
rounding of float64, and the reference in float32 (the control) fails the
cell's limits; the landmark counters of the tracer add up.
"""

import importlib
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import drivers, program_spans, scenes
from benchmark.reference.precision import FLOAT32, FLOAT64
from benchmark.scenes import victoria_park
from benchmark.tests.small import SEED, small_spec
from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
from slam_plus_plus_tpu_torch.utils import timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "victoria.fastl"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    with open(os.path.join(ROOT, "benchmark", "configs", "landmark-victoria-park.json")) as f:
        return json.load(f)["scene"]["params"]


def test_scene_has_the_published_counts(tmp_path):
    """6,969 poses, 151 trees, 6,968 odometry edges and 3,640 sightings,
    every tree seen twice or more, no pose-pose closure; vertex ids by
    first use and edges by their newer vertex; two seeds give one graph
    and other measurements, which the parser reads as ``as_read`` says."""
    a, b = (victoria_park.generate(_params(), s) for s in (SEED, 11))
    assert (a.n_poses, a.n_landmarks, a.n_edges) == (6969, 151, 10608)
    odo = a.odometry
    assert odo.sum() == 6968 and (~odo).sum() == 3640
    assert np.array_equal(a.edge_i[odo], a.pose_id[:-1])
    assert np.array_equal(a.edge_j[odo], a.pose_id[1:])
    assert np.isin(a.edge_i[~odo], a.pose_id).all()
    seen = np.bincount(a.edge_j[~odo], minlength=7120)[a.landmark_id]
    assert np.isin(a.edge_j[~odo], a.landmark_id).all() and seen.min() >= 2
    ids = np.concatenate([a.pose_id, a.landmark_id])
    assert np.array_equal(np.sort(ids), np.arange(7120))
    newer = np.maximum(a.edge_i, a.edge_j)
    assert (np.diff(newer) >= 0).all()
    # each vertex is first named by an edge whose newer vertex it is
    _, first = np.unique(np.stack([a.edge_i, a.edge_j], 1).reshape(-1), return_index=True)
    assert (np.sort(first) % 2 == 1)[1:].all()
    for k in ("pose_id", "landmark_id", "edge_i", "edge_j", "odometry", "info"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert not np.array_equal(a.z, b.z)
    # sightings lie within the radius, each of a tree beside the track
    gap = np.linalg.norm(a.z[~odo, :2], axis=1)
    assert gap.max() < _params()["radius"] + 5 * _params()["obs_noise"]

    small = victoria_park.generate(dict(_params(), n_poses=300, n_landmarks=20,
                                        observations=160), SEED)
    path = str(tmp_path / "vp.g2o")
    small.write(path)
    r = small.as_read()
    system = parse_g2o_fast(path)
    assert system.vertex_stores["pose2d"].n == 300
    assert system.vertex_stores["landmark2d"].n == 20
    st = system.edge_stores["edge_pose2d"]
    assert np.array_equal(st.measurements[:st.n], r.z[r.odometry])
    assert np.array_equal(st.informations[:st.n], r.info[r.odometry])
    st = system.edge_stores["edge_pose_landmark2d"]
    from benchmark.reference.landmark_fastl import to_polar

    assert np.array_equal(st.measurements[:st.n], to_polar(r.z[~r.odometry, :2]))
    assert np.array_equal(st.vertex_ids[:st.n], np.stack([small.edge_i, small.edge_j],
                                                         1)[~small.odometry])
    pre = small.prefix(100)
    assert pre.n_poses == 100 and (np.maximum(pre.edge_i, pre.edge_j) < small.pose_id[100]).all()
    assert pre.n_edges == int((np.maximum(small.edge_i, small.edge_j) < small.pose_id[100]).sum())


def _replayed(tmp_path, seed):
    """The cell at test size on the CPU, as a run builds it (the scene, its
    file, the port's parser, the replay driver), after one unit: (its
    limits, the driver, the reference module, the reference's answer,
    the scene, the traffic).  Built here, not by ``benchmark.run``, whose
    check for JAX the tests' own imports would trip."""
    spec = small_spec(tmp_path)
    cell = spec.workload(CELL)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    scene = scenes.generate(cfg, seed)
    path = scenes.scene_file(cfg, scene, seed, str(tmp_path / "cache"))
    d = drivers.build(parse_g2o_fast(path), scene, cfg, traffic, "cpu")
    assert math.isfinite(d.unit())
    ref_mod = importlib.import_module(
        f"benchmark.reference.{traffic.get('reference', cfg['reference'])}")
    assert ref_mod.__name__.endswith("landmark_fastl") and cfg["control"] == "float32"
    ref = ref_mod.solve(scene.as_read(), traffic, FLOAT64, "cpu")
    return spec.limits(CELL), d, ref_mod, ref, scene, traffic


@pytest.mark.parametrize("seed", [SEED, 11])
def test_the_port_agrees_with_the_reference(tmp_path, seed):
    limits, d, ref_mod, ref, _scene, _traffic = _replayed(tmp_path, seed)
    ans = d.answer()
    assert ans["pose2d"].shape == (300, 3) and ans["landmark2d"].shape == (20, 2)
    numbers = ref_mod.compare(ans, ref)
    assert set(numbers) == set(limits) == {"chi2_of_states_rel", "pose_t_gap", "pose_r_gap",
                                           "landmark_gap"}
    # float64 on both sides: the gaps of rounding alone, the final chi2s too
    numbers["chi2_rel"] = abs(ans["chi2"] - ref["chi2"]) / ref["chi2"]
    for name, v in numbers.items():
        assert v <= 1e-6, (name, v)
    assert ref["solve_points"] == d.solver.stats["solve_points"] > 100
    assert ref["pushes"] == d.solver.stats["pushes"]


def test_the_float32_control_fails(tmp_path):
    limits, _d, ref_mod, ref, scene, traffic = _replayed(tmp_path, SEED)
    ctl = ref_mod.solve(scene.as_read(), traffic, FLOAT32, "cpu")
    numbers = ref_mod.compare(ref_mod.as_answer(ctl), ref)
    assert any(v > limits[k]["limit"] for k, v in numbers.items()), numbers


def test_landmark_counters_add_up(tmp_path, capsys):
    """Traced, each solve point's per-type pending edges sum to its
    ``fastl.pending_edges``, the flushes' activations to the vertices fed,
    and each point with pending edges counts the levels its walk reaches;
    the tool's table shows each counter.  Off, nothing is recorded and
    the replay is bitwise the same."""
    spec = small_spec(tmp_path)
    cfg = spec.config("landmark-victoria-park")
    scene = scenes.generate(cfg, SEED)
    path = scenes.scene_file(cfg, scene, SEED, str(tmp_path / "cache"))
    d = drivers.build(parse_g2o_fast(path), scene, cfg, spec.traffic("fastl_replay"), "cpu")
    timer.disable()
    timer.drain()
    chi2 = d.unit()
    off = d.answer()
    assert timer.drain()["counts"] == []
    on, program = program_spans.record(timer, d.unit)
    assert on == chi2
    for t in ("pose2d", "landmark2d"):
        np.testing.assert_array_equal(d.answer()[t], off[t])
    counts = program.counts
    total = {c.span: c.n for c in counts if c.name == "fastl.pending_edges"}
    typed = {}
    for c in counts:
        if c.name.startswith("fastl.pending_edges."):
            typed[c.span] = typed.get(c.span, 0) + c.n
    assert len(total) == d.solver.stats["solve_points"]
    assert {s: n for s, n in total.items() if n} == typed
    fed = {}
    for c in counts:
        if c.name.startswith("fastl.activations."):
            fed[c.name] = fed.get(c.name, 0) + c.n
    assert fed == {"fastl.activations.pose2d": scene.n_poses,
                   "fastl.activations.landmark2d": scene.n_landmarks}
    levels = [c.n for c in counts if c.name == "inc.walk_levels"]
    assert len(levels) == sum(1 for n in total.values() if n)
    L = len(d.solver.chol.plan.levels)
    assert min(levels) >= 0 and max(levels) == L
    program_spans.print_table(program, 1, {})
    table = capsys.readouterr().err
    for name in ("fastl.pending_edges.edge_pose2d", "fastl.pending_edges.edge_pose_landmark2d",
                 "fastl.activations.pose2d", "fastl.activations.landmark2d", "inc.walk_levels"):
        assert f"counter {name}: " in table, name
