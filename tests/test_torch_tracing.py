"""The port's tracer (utils/timer.py) and the spans placed in FastL, LM, the
Schur and the block Cholesky, on the CPU: off, it records nothing and
costs a shared no-op; on, its spans count what the solvers count, nest
inside their parents, never synchronize a device, and leave every result
bitwise as it was; its clock anchor puts a span on torch.profiler's
timeline."""

import time

import numpy as np
import pytest
import torch

from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg.incremental_cholesky import IncrementalCholesky
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver
from slam_plus_plus_tpu_torch.utils import timer


@pytest.fixture(autouse=True)
def _tracer_off_and_no_sync(monkeypatch):
    """Each test starts and ends with tracing off and nothing recorded, and
    a device synchronization anywhere fails it."""
    def refuse(*_a, **_k):
        raise AssertionError("a span synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    timer.disable()
    timer.drain()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    timer.disable()
    timer.drain()


def _traced(fn):
    """fn() run with the tracer on: (its result, the drained records)."""
    timer.enable()
    try:
        out = fn()
    finally:
        rec = timer.drain()
        timer.disable()
    return out, rec


def _check_nesting(spans):
    """Every span lies inside its parent's interval and shares its unit; a
    root is its own unit."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent == 0:
            assert s.unit == s.id
            continue
        p = by_id[s.parent]
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
        assert s.unit == p.unit


def _names(spans, name):
    return [s for s in spans if s.name == name]


def test_disabled_span_is_the_shared_noop():
    assert not timer.enabled()
    ctx = timer.span("lm.trial", level=3)
    assert ctx is timer.NO_SPAN and timer.span("x") is ctx
    with ctx:
        timer.count("inc.dirty_blocks", 7)
    rec = timer.drain()
    assert rec["spans"] == [] and rec["counts"] == []
    # on, then off again: what ran while off left nothing
    _, rec = _traced(lambda: timer.count("c", 2))
    with timer.span("after"):
        pass
    assert [c.name for c in rec["counts"]] == ["c"] and timer.drain()["spans"] == []


@pytest.fixture(scope="module")
def manhattan(tmp_path_factory):
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=91, loop_prob=0.35)
    p = str(tmp_path_factory.mktemp("tracing") / "m300.g2o")
    D.write_g2o_2d(p, edges, poses)
    return p


@pytest.mark.parametrize("refresh, dx_threshold", [("dirty", 20.0), ("dirty", 0.05),
                                                   ("full", 20.0)])
def test_fastl_replay_spans(manhattan, refresh, dx_threshold):
    """refresh "full": capacities so small that every walk overflows, so
    every omega step takes the full redescent."""
    def replay():
        fl = FastLSolver(parse_g2o(manhattan), device="cpu", dx_threshold=dx_threshold)
        if refresh == "full":
            fl.inc = IncrementalCholesky(fl.chol, caps=dict(d=1, e=1, w=1, p=1))
            fl._walk_schedule()
        out = fl.run()
        return fl, out, {t: s.data.copy() for t, s in fl.system.vertex_stores.items()}

    fl0, (chi2_0, it_0), states_0 = replay()
    (fl, (chi2, iters), states), rec = _traced(replay)
    spans, counts = rec["spans"], rec["counts"]
    # results bitwise as the untraced run's
    assert chi2 == chi2_0 and iters == it_0
    assert {k: v for k, v in fl.stats.items() if k != "elapsed"} == \
        {k: v for k, v in fl0.stats.items() if k != "elapsed"}
    for t in states_0:
        np.testing.assert_array_equal(states[t], states_0[t])
    assert fl.stats["pushes"] > (0 if dx_threshold < 1.0 else -1)

    _check_nesting(spans)
    (root,) = _names(spans, "fastl.replay")
    assert root.parent == 0 and all(s.unit == root.id for s in spans)
    points = _names(spans, "fastl.solve_point")
    assert len(points) == fl.stats["solve_points"] > 3
    assert all(p.parent == root.id and {"step", "n_active"} <= set(p.attrs) for p in points)
    # one read of |dx| per iteration inside the solve points, then the
    # final chi2 and, without a push landing last, the one-time dx's check
    syncs = _names(spans, "host_sync")
    in_points = {p.id for p in points}
    assert sum(s.parent in in_points for s in syncs) == fl.stats["iters"] == iters
    tail = [s for s in syncs if s.parent == root.id]
    assert len(tail) in (1, 2) and len(syncs) == iters + len(tail)
    assert len(_names(spans, "fastl.update")) >= fl.stats["pushes"]
    # each full refactorization (an overflow's among them), and the
    # trailing one of closures left pending
    rebuilds = fl.stats["full_refactors"]
    assert 0 <= len(_names(spans, "fastl.rebuild")) - rebuilds <= 1
    per_point = [c for c in counts if c.name == "fastl.pending_edges"]
    assert len(per_point) == len(points) and {c.span for c in per_point} == in_points
    dirty = [c for c in counts if c.name == "inc.dirty_blocks"]
    # one graph record a solve point: replayed, or eager with its reason
    graph = [c for c in counts if c.name.startswith("fastl.graph_")]
    assert sorted(c.span for c in graph) == sorted(in_points)
    assert fl.stats["graph_replays"] + fl.stats["graph_eager"] == len(points)
    reasons = {c.name.rsplit(".", 1)[1] for c in graph}
    assert len(dirty) == fl.stats["omega_steps"] and all(c.n > 0 for c in dirty)
    assert _names(spans, "inc.solve")
    assert len(_names(spans, "fastl.pack")) == sum(c.name.endswith(".cpu") for c in graph)
    if refresh == "dirty":
        assert _names(spans, "inc.refresh")
        assert "cpu" in reasons and reasons <= {"cpu", "overflow", "no_omega"}
    else:
        assert fl.stats["dirty_overflows"] == fl.stats["omega_steps"] > 0
        assert all(c.n == fl.inc.KH for c in dirty) and not _names(spans, "inc.refresh")
        assert "overflow" in reasons and reasons <= {"overflow", "no_omega"}
    levels = _names(spans, "chol.level")
    assert levels and {s.attrs["phase"] for s in levels} >= {"factor", "down", "up"}


@pytest.fixture(scope="module")
def ba_scene(tmp_path_factory):
    cams, pts, obs = D.make_ba_scene_large(n_cams=24, n_points=400, obs_per_point=6, seed=5)
    p = str(tmp_path_factory.mktemp("tracing") / "ba.g2o")
    D.write_g2o_ba(p, cams, pts, obs)
    return p


@pytest.mark.parametrize("route", ["sparse_reduced", "dense"])
def test_lm_schur_spans(ba_scene, route):
    def solve():
        lm = LevenbergMarquardtSolver(parse_g2o(ba_scene), device="cpu")
        if route == "sparse_reduced":
            lm._schur = SchurSolver(lm.asm, sparse_reduced_limit=1)
        assert lm._schur.sparse_reduced == (route == "sparse_reduced")
        out = lm.optimize(5, 0.01)
        return lm, out, {t: s.data.copy() for t, s in lm.system.vertex_stores.items()}

    lm0, out0, states_0 = solve()
    (lm, out, states), rec = _traced(solve)
    spans = rec["spans"]
    assert out == out0 and lm.trial_log == lm0.trial_log
    for t in states_0:
        np.testing.assert_array_equal(states[t], states_0[t])

    _check_nesting(spans)
    (root,) = _names(spans, "lm.optimize")
    trials = _names(spans, "lm.trial")
    assert len(trials) == len(lm.trial_log) >= 2
    assert all(t.parent == root.id for t in trials)
    solves = _names(spans, "schur.solve")
    assert len(solves) == len(trials)
    by_id = {s.id: s for s in spans}
    for child in ("schur.w_rhs", "schur.sc_fill", "schur.factor", "schur.back_substitute"):
        got = _names(spans, child)
        assert len(got) == len(solves) and all(by_id[s.parent].name == "schur.solve"
                                               for s in got)
    assert len(_names(spans, "asm.assemble")) == len(trials) + 1
    assert len(_names(spans, "lm.update")) == len(trials)
    # the states go up once and come back once
    moves = _names(spans, "asm.snapshot") + _names(spans, "asm.writeback")
    assert [by_id[s.parent].name for s in moves] == ["lm.optimize"] * 2
    # two reads of the base system, one per trial, the final chi2
    assert len([s for s in _names(spans, "host_sync") if s.parent == root.id]) == \
        len(trials) + 3
    if route == "sparse_reduced":
        factors = _names(spans, "chol.factor")
        assert len(factors) == len(solves) and len(_names(spans, "chol.solve")) == len(solves)
        levels = _names(spans, "chol.level")
        n_levels = lm._schur.reduced_chol.n_levels
        assert len(levels) == 3 * n_levels * len(solves)
        assert sorted({s.attrs["level"] for s in levels}) == list(range(n_levels))


def test_anchor_maps_a_span_onto_the_profiler_clock():
    """A span around a matmul, moved by the clock anchor onto the
    profiler's unix-nanosecond timeline, holds the aten::mm event within
    100 microseconds at either end."""
    from torch.autograd import profiler

    a = torch.randn(256, 256, dtype=torch.float64)
    a @ a                                    # the first call's set-up, untimed
    timer.enable()
    with profiler.profile(use_cpu=True) as prof:
        with timer.span("mm"):
            a @ a
        time.sleep(0.001)
    rec = timer.drain()
    timer.disable()
    (s,) = rec["spans"]
    enable_anchor, drain_anchor = rec["anchor_ns"]
    assert abs(drain_anchor - enable_anchor) < 1_000_000      # drift under 1 ms
    t0, t1 = s.t0 + enable_anchor, s.t1 + enable_anchor
    (mm,) = [e for e in prof.kineto_results.events() if e.name() == "aten::mm"]
    slack = 100_000
    assert t0 - slack <= mm.start_ns() and mm.start_ns() + mm.duration_ns() <= t1 + slack


def test_stage_timer_stage_is_a_span():
    st = timer.StageTimer()
    with st.stage("chol"):                    # off: totals only
        pass
    assert timer.drain()["spans"] == []
    timer.enable()
    with st.stage("chol"):
        with timer.span("inner"):
            pass
    rec = timer.drain()
    timer.disable()
    assert [s.name for s in rec["spans"]] == ["inner", "chol"] and st.counts["chol"] == 2
    _check_nesting(rec["spans"])
