"""Port parity for the streaming FastL (solvers/fastl_online.py) and the
maintained factor's standalone dirty step (FastLSolver.absorb with a walk,
as the stream takes it), float64 on the CPU, against the JAX package's
OnlineFastLSolver (its JAX engine) and the port's own replay.

Tolerances: a stream with no growth rebuild is exact against the replay
FastL (1e-6 absolute, the JAX test's bound) and against the JAX package's
stream (1e-8 relative: both pass through two packages' factorizations);
a stream with growth rebuilds has the JAX package's counts exactly and
its chi2 to 1e-8 relative, and stays within the JAX test's rebuild bound
and chi2 <= 1.3 x replay + 10; the dirty step's factor against a full
redescent of the same lambda through their solves, 1e-8 x scale (the
dirty step keeps the last full factorization's Jacobi scaling, so the
blocks themselves differ by the scaling; two factorizations of a pose
graph's lambda, kappa ~1e8, measured 1.3e-10), and its stores against the JAX
package's refactor_dirty on the same lambda 1e-10 x scale, the
bottom's Cholesky factor 1e-8 (two packages' factorizations); ``ok`` of
the port's step also asserts that it updated the stores in place.
Every stream keeps its capacity above the 32-vertex bottom, so both
engines have elimination levels (ROADMAP.md Queue 3: the JAX dirty step
double-adds without them).
"""

import numpy as np
import pytest
import torch

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.solvers.fastl import FastLSolver as JFastL
from slam_plus_plus_tpu.solvers.fastl_online import OnlineFastLSolver as JOnline
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.incremental_cholesky import OMEGA_CAP
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
from slam_plus_plus_tpu_torch.solvers.fastl_online import OnlineFastLSolver


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _manhattan(tmp_path, n, seed, **kw):
    poses, edges = D.make_manhattan_2d(n_poses=n, seed=seed, **kw)
    p = str(tmp_path / f"m{n}_{seed}.g2o")
    D.write_g2o_2d(p, edges, poses)
    return p


def _stream(system, online):
    store = system.edge_stores["edge_pose2d"]
    for (_en, li) in system._edge_insert_log:
        vids = store.vertex_ids[li]
        online.add_edge(int(vids[0]), int(vids[1]), store.measurements[li],
                        store.informations[li])
    return online.finish()


COUNTS = ("rebuilds", "closures", "solves", "pushes", "steps")


def test_no_growth_stream_is_exact(tmp_path):
    """Within one capacity (no growth rebuild) the chain activations and the
    Woodbury fringe reproduce the replay engine, and the JAX package's
    stream."""
    p = _manhattan(tmp_path, 200, 3)
    chi2_r, _ = FastLSolver(tparse(p), device="cpu").run()
    chi2_o, stats = _stream(tparse(p), OnlineFastLSolver(device="cpu", initial_capacity=256))
    jchi2, jstats = _stream(jparse(p), JOnline(initial_capacity=256))
    assert stats["rebuilds"] == 1 and stats["closures"] > 0 and stats["solves"] > 0
    assert chi2_o == pytest.approx(chi2_r, abs=1e-6)
    assert {k: stats[k] for k in COUNTS} == {k: jstats[k] for k in COUNTS}
    assert abs(chi2_o - jchi2) <= 1e-8 * jchi2


def test_growth_stream_matches_jax(tmp_path, monkeypatch):
    """About 300 poses from a capacity of 64 and a fringe of 16: capacity
    doublings and fringe overflows rebuild the engine, with the JAX
    package's counts and chi2, within the JAX test's bounds against the
    replay."""
    p = _manhattan(tmp_path, 300, 3)
    monkeypatch.setattr(OnlineFastLSolver, "FRINGE_CAP", 16)
    on = OnlineFastLSolver(device="cpu", initial_capacity=64)
    chi2_o, stats = _stream(tparse(p), on)
    jchi2, jstats = _stream(jparse(p), JOnline(initial_capacity=64, fringe_cap=16))
    assert {k: stats[k] for k in COUNTS} == {k: jstats[k] for k in COUNTS}
    assert abs(chi2_o - jchi2) <= 1e-8 * jchi2
    assert stats["rebuilds"] >= 4 and on.capacity == 512
    chi2_r, _ = FastLSolver(tparse(p), device="cpu").run()
    bound = (int(np.ceil(np.log2(300 / 64))) + 1 + int(np.ceil(stats["closures"] / 16)) + 1)
    assert stats["rebuilds"] <= bound, stats
    assert chi2_o <= chi2_r * 1.3 + 10.0


@pytest.fixture(scope="module")
def dirty_step(tmp_path_factory):
    """One dirty step of each package's maintained factor on the same
    manhattan: the stores at a solve point after the pending edges' omega
    and the dirty refresh (the port's absorb from the batch's walk, the JAX
    package's _apply_pending and refactor_dirty); the port's entry also
    keeps what the step started from."""
    p = _manhattan(tmp_path_factory.mktemp("dirty"), 160, 5, loop_prob=0.4)
    out = {}
    for name, fl in (("port", FastLSolver(tparse(p), device="cpu")),
                     ("jax", JFastL(jparse(p), every_n=1, use_native=False))):
        asm = fl.asm
        states = asm.snapshot_states(fl.system)
        steps = fl.steps
        # the first 100 edges active, the next 12 pending
        counts = {n: 0 for n in asm.edge_data}
        pending = []
        for si, st in enumerate(fl.steps[:112]):
            if si < 100:
                counts[st["ename"]] += 1
                continue
            nm = np.zeros(2)
            for (slot, _gid) in st["new_vs"]:
                nm[slot] = 1.0
            pending.append((st["ename"], st["li"], nm))
        n_active = fl.steps[99]["n_active"]
        if name == "port":
            stores, eta0 = fl.rebuild(states, counts, n_active)
            walk = fl.walk(pending)
            ok = walk is not None and fl.absorb(stores, eta0, states, pending, walk) is stores
            out[name] = (fl, {k: v.clone() for k, v in stores.items()}, ok,
                         (states, counts, n_active, pending))
        else:
            stores, eta0 = fl._init_stores(states, counts, n_active)
            eta0, pos, vals = fl._apply_pending(stores, eta0, states, pending)
            ok = fl.inc.refactor_dirty(stores, pos, vals)
            out[name] = (fl, {k: np.asarray(v) for k, v in stores.items()}, ok)
    return out


def test_refactor_dirty_equals_a_full_redescent(dirty_step):
    """The dirty step keeps the Jacobi scaling of the last full
    factorization, a full redescent takes the new lambda's, so the two
    factors hold differently scaled blocks of the same lambda: they are
    compared through what they compute, the solve of three seeded
    right-hand sides."""
    fl, st, ok, _ctx = dirty_step["port"]
    inc = fl.inc
    assert ok and len(fl.chol.plan.levels) >= 2
    full = inc.refactor_full({k: v.clone() for k, v in st.items()})
    b = torch.as_tensor(np.random.default_rng(8).normal(size=(fl.asm.Np, fl.asm.Bp, 3)))
    got, want = inc.solve(st, b), inc.solve(full, b)
    assert (got - want).abs().max() <= 1e-8 * want.abs().max()


def test_refactor_dirty_matches_jax(dirty_step):
    fl, st, ok, _ctx = dirty_step["port"]
    jfl, jst, jok = dirty_step["jax"]
    inc = fl.inc
    assert ok and jok
    for k, n in (("H", inc.KH), ("C", inc.NC), ("W", inc.NW), ("P", inc.NP)):
        got, want = st[k][:n].numpy(), jst[k][:n]
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max(), k
    assert np.abs(st["L"].numpy() - jst["L"]).max() <= 1e-8 * np.abs(jst["L"]).max()


def test_refactor_dirty_reports_an_overflow(dirty_step):
    """Past the omega capacity the walk reports an overflow (None), and
    absorb without a walk takes the full redescent: fresh stores, which
    solve as the dirty step's factor of the same lambda (1e-8 x scale, as
    above)."""
    fl, st, _ok, (states, counts, n_active, pending) = dirty_step["port"]
    inc = fl.inc
    assert inc.prepare_host_batch([[np.arange(OMEGA_CAP + 1) % inc.K0]]) == [None]
    stores, eta0 = fl.rebuild(states, counts, n_active)
    full = fl.absorb(stores, eta0, states, pending, None)
    assert full is not stores
    b = torch.as_tensor(np.random.default_rng(9).normal(size=(fl.asm.Np, fl.asm.Bp, 3)))
    got, want = inc.solve(full, b), inc.solve(st, b)
    assert (got - want).abs().max() <= 1e-8 * want.abs().max()


def test_out_of_order_ids_are_refused():
    on = OnlineFastLSolver(device="cpu")
    on.add_edge(0, 1, np.zeros(3), np.eye(3))
    with pytest.raises(ValueError, match="incremental vertex ids"):
        on.add_edge(1, 5, np.zeros(3), np.eye(3))

