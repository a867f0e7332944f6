"""FastL's solve-point runner (solvers/fastl_graph.py).

On the CPU the runner runs every solve point eagerly from its held buffers
(the staging buffer, its device copy, the held stores, eta0 and states):
its results are bitwise those of FastLSolver.absorb from the point's walk
followed by IncrementalCholesky.solve_with_norm, the held tensors
keep their storage through pushes and overflows, and its counters account
for every solve point.  The ``card`` test holds the CUDA graph replay
bitwise to the eager replay on the card; it skips without one and runs
there by

    python -m pytest --noconftest -m card tests/test_torch_fastl_graph.py

(the repository's conftest imports JAX, which the card's machine lacks).
"""

import json
import os

import numpy as np
import pytest
import torch

from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg.incremental_cholesky import IncrementalCholesky
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
from slam_plus_plus_tpu_torch.solvers.fastl_graph import STATIC, SolvePointRunner
from slam_plus_plus_tpu_torch.utils import timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def manhattan(tmp_path_factory):
    """The manhattan acceptance row's generator at 300 poses."""
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=101, loop_prob=0.3)
    p = str(tmp_path_factory.mktemp("fastl_graph") / "m300.g2o")
    D.write_g2o_2d(p, edges, poses)
    return p


def _by_step(fl):
    """fl's solve points through absorb (from the point's walk) and
    IncrementalCholesky.solve_with_norm on the runner's held stores, in
    place of the runner."""
    def solve_point(chunks, hp):
        r = fl._runner
        pending = [(en, int(el), nm) for (en, els, nmc, valid) in chunks
                   for el, nm, v in zip(els, nmc, valid) if v]
        again = fl._pending_chunks(pending)
        assert len(again) == len(chunks)
        for a, b in zip(again, chunks):
            assert a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
        assert fl.absorb(r.stores, r.eta0, r.states, pending, hp) is r.stores
        return fl.inc.solve_with_norm(r.stores, r.eta0)
    fl._solve_point = solve_point


def _record(fl):
    """After each solve point through the runner's route: the held H, C,
    W, P, dense and eta0, dx, and the held tensors' storage."""
    seen = []
    inner = fl._solve_point

    def spy(chunks, hp):
        dx, norm = inner(chunks, hp)
        r = fl._runner
        seen.append(dict({k: r.stores[k].clone() for k in ("H", "C", "W", "P", "dense")},
                         eta0=r.eta0.clone(), dx=dx.clone(), n_chunks=len(chunks),
                         ptrs=_ptrs(r)))
        return dx, norm
    fl._solve_point = spy
    return seen


def _ptrs(r):
    return ([r.stores[k].data_ptr() for k in STATIC] + [r.eta0.data_ptr()]
            + [x.data_ptr() for x in r.states.values()]
            + [r.stage.data_ptr(), r.dev_in.data_ptr()])


def _replay(path, caps=None, **kw):
    """A CPU FastLSolver of path; caps: the dirty step's capacities (small
    ones force overflows), set as the incremental engine's tests set them."""
    fl = FastLSolver(parse_g2o(path), device="cpu", **kw)
    if caps is not None:
        fl.inc = IncrementalCholesky(fl.chol, caps=caps)
        fl._walk_schedule()
    return fl


def _finish(fl):
    """(chi2, iterations, states) of a run from the parsed estimate, which
    is restored afterwards (run() writes its solution back)."""
    start = {t: s.data.copy() for t, s in fl.system.vertex_stores.items()}
    chi2, it = fl.run()
    end = {t: s.data.copy() for t, s in fl.system.vertex_stores.items()}
    for t, x in start.items():
        fl.system.vertex_stores[t].states[:len(x)] = x
    return chi2, it, end


@pytest.mark.parametrize("case", ["default", "pushes_and_overflows"])
def test_runner_is_bitwise_apply_pending_and_step(manhattan, case):
    """At every solve point through the runner, the held stores, eta0 and
    dx equal those of absorb + IncrementalCholesky.solve_with_norm bit for
    bit, one omega batch or several; so do the replay's chi2, iterations and states.  With a low
    push threshold and capacities at the walk's 75th percentile, the replay pushes
    and overflows, and the held tensors keep their storage through both,
    through every rebuild and into a second run."""
    kw = {} if case == "default" else dict(dx_threshold=0.5)
    caps = None
    if case != "default":
        psz = FastLSolver(parse_g2o(manhattan), device="cpu").inc.last_batch_per_solve
        caps = {k: int(np.percentile(psz[k], 75)) + 1 for k in "dewp"}
    runs = []
    for route in ("runner", "step"):
        fl = _replay(manhattan, caps, **kw)
        if route == "step":
            fl._runner = SolvePointRunner(fl)
            _by_step(fl)
        seen = _record(fl)
        runs.append((fl, seen, _finish(fl)))
    (fl, seen, (chi2, it, states)), (_fl, want, (w_chi2, w_it, w_states)) = runs
    assert len(seen) == len(want) > 15
    assert any(s["n_chunks"] > 1 for s in seen)
    for got, ref in zip(seen, want):
        for k in ("H", "C", "W", "P", "dense", "eta0", "dx"):
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, equal_nan=True, msg=k)
    assert chi2 == w_chi2 and it == w_it
    for t in states:
        np.testing.assert_array_equal(states[t], w_states[t])
    st = fl.stats
    assert st["graph_replays"] == st["graph_captures"] == 0
    assert st["graph_eager"] == st["solve_points"]
    if case != "default":
        assert st["pushes"] > 0 and st["dirty_overflows"] > 0
        assert len(seen) + st["dirty_overflows"] <= st["solve_points"]
    # one storage for every held tensor, through the whole replay and the next
    ptrs = {tuple(s["ptrs"]) for s in seen}
    assert len(ptrs) == 1
    again = _finish(fl)
    assert again[0] == chi2 and tuple(_ptrs(fl._runner)) in ptrs
    assert {tuple(s["ptrs"]) for s in seen} == ptrs


def test_runner_counters_account_for_every_solve_point(manhattan):
    """Traced, each solve point counts one ``fastl.graph_replays`` or one
    ``fastl.graph_eager.<reason>`` record inside its span; on the CPU every
    reason is the device's or the overflow's, and stats agree."""
    psz = FastLSolver(parse_g2o(manhattan), device="cpu").inc.last_batch_per_solve
    caps = {k: int(np.percentile(psz[k], 75)) + 1 for k in "dewp"}
    fl = _replay(manhattan, caps)
    timer.enable()
    try:
        fl.run()
    finally:
        rec = timer.drain()
        timer.disable()
    points = {s.id for s in rec["spans"] if s.name == "fastl.solve_point"}
    graph = [c for c in rec["counts"] if c.name.startswith("fastl.graph_")]
    assert len(points) == fl.stats["solve_points"] > 20
    assert sorted(c.span for c in graph) == sorted(points)
    reasons = {c.name for c in graph}
    assert reasons == {"fastl.graph_eager.cpu", "fastl.graph_eager.overflow"}
    n_over = sum(c.name.endswith("overflow") for c in graph)
    assert n_over == fl.stats["dirty_overflows"] > 0
    assert fl.stats["graph_eager"] == len(graph)
    assert any(s.name == "fastl.pack" for s in rec["spans"])


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

#: a seed of the benchmark cells manhattan3500.fastl and victoria.fastl (their
#: scenes: the configuration's graph, this seed's measurement noise)
CELL_SEED = 2_876_543_210


def _cell_system(n_poses, config="pose-manhattan3500"):
    """The first n_poses poses of a benchmark configuration's scene (with
    every edge among them) as the port's parser reads its file."""
    import tempfile

    from benchmark import scenes

    with open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    scene = scenes.generate(cfg, CELL_SEED).prefix(n_poses)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cell.g2o")
        scene.write(path)
        return parse_g2o(path)


def _graph_and_eager(system, **kw):
    """(graph solver, its run, the eager solver's run) on the card: the
    same system replayed through the captured graphs and by a runner that
    runs every point eagerly, bitwise equal in chi2, iterations, pushes and
    states (and in-loop marginals where kw asks for them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eager = FastLSolver(system(), device="cuda", **kw)
    eager._runner = SolvePointRunner(eager)
    eager._runner.eager_reason = "reference"
    want = _finish(eager)
    fl = FastLSolver(system(), device="cuda", **kw)
    got = _finish(fl)
    assert fl._runner.capture_failure is None
    assert got[:2] == want[:2] and fl.stats["pushes"] == eager.stats["pushes"]
    for t in got[2]:
        np.testing.assert_array_equal(got[2][t], want[2][t])
    if fl.marginals:
        assert torch.equal(fl.sigma_diag(), eager.sigma_diag())
        assert fl.marginals_trace == eager.marginals_trace
    st = fl.stats
    assert st["graph_captures"] == len(fl._runner._graphs) >= 1
    assert st["graph_replays"] + st["graph_eager"] == st["solve_points"]
    print(f"{st}; keys {sorted(fl._runner._graphs, key=len)}")
    return fl, got


@pytest.mark.card
@pytest.mark.parametrize("config, n_poses", [
    ("pose-manhattan3500", 300), ("pose-manhattan3500", 3500),
    ("landmark-victoria-park", 1000), ("landmark-victoria-park", 6969)])
def test_graph_replay_is_bitwise_the_eager_replay(config, n_poses):
    """On the card, float64, a FastL cell's graph and a prefix of it (the
    Victoria Park stream's keys mix odometry and range-bearing batches):
    the graph replay is bitwise the eager one; the graphs replay 95% of the
    solve points or more, are captured once per key in the solver's first
    run, and replay in its second run with nothing captured."""
    import slam_plus_plus_tpu_torch.models  # noqa: F401  (registers the types)

    fl, got = _graph_and_eager(lambda: _cell_system(n_poses, config))
    st = fl.stats
    assert st["graph_replays"] >= 0.95 * st["solve_points"]
    second = _finish(fl)
    assert second[:2] == got[:2]
    assert fl.stats["graph_captures"] == 0
    assert fl.stats["graph_replays"] >= st["graph_replays"] + 1


@pytest.mark.card
@pytest.mark.parametrize("case", ["marginals", "sphere"])
def test_graph_replay_serves_the_other_callers(tmp_path, case):
    """On the card: the in-loop marginals (the association app's route)
    read the graphs' factor as the eager replay's, and an SE(3) replay (6
    wide blocks: the pivot inverses' sub-block gathers) captures."""
    if case == "marginals":
        _graph_and_eager(lambda: _cell_system(300), marginals=True)
        return
    poses, edges = D.make_sphere_3d(n_poses=300, seed=103, trans_noise=0.01, rot_noise=0.005)
    p = str(tmp_path / "sphere300.g2o")
    D.write_g2o_3d(p, edges, poses)
    fl, _got = _graph_and_eager(lambda: parse_g2o(p))
    assert fl.asm.Bp == 6 and fl.stats["graph_replays"] > 0
