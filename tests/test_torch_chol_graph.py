"""The sparse-reduced Schur's graphed block Cholesky (linalg/chol_graph.py).

On the CPU the graphed solver runs every call eagerly from its held inputs:
its answers are bitwise the plain BlockCholeskySolver's through the
Schur's clique and gathered paths, a float32 system whose ladder's first
rung fails takes the plain solver's whole ladder, and its counters account
for every call.  Only the sparse-reduced Schur builds it.  The ``card``
tests hold the CUDA graph replay bitwise to the eager chain at ring871's
reduced pattern; they skip without a card and run there by

    python -m pytest --noconftest -m card tests/test_torch_chol_graph.py

(the repository's conftest imports JAX, which the card's machine lacks).
"""

import warnings

import numpy as np
import pytest
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.chol_graph import GraphedBlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
from slam_plus_plus_tpu_torch.parallel import DistributedBlockCholeskySolver
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
from slam_plus_plus_tpu_torch.solvers.lm import damp_system
from slam_plus_plus_tpu_torch.utils import timer

#: a bottom small enough that the test scene's reduced system runs levels
BOTTOM = 32
#: LM damping of the three trials, x the largest diagonal entry
DAMPING = (1e-4, 1e-3, 1e-2)


@pytest.fixture(autouse=True)
def _tracer_off():
    timer.disable()
    timer.drain()
    yield
    timer.disable()
    timer.drain()


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """A BA file of 200 cameras on a ring, each point seen by its 4
    nearest: a banded reduced camera system (8 levels above BOTTOM)."""
    cams, pts, obs = D.make_ba_scene_large(n_cams=200, n_points=1600, obs_per_point=4,
                                           seed=11)
    p = str(tmp_path_factory.mktemp("chol_graph") / "ring200.g2o")
    D.write_g2o_ba(p, cams, pts, obs)
    return p


def _schur(path, dtype):
    """(the forced sparse-reduced SchurSolver, its undamped system)."""
    system = parse_g2o(path)
    asm = Assembler(system, device="cpu", dtype=dtype)
    return SchurSolver(asm, sparse_reduced_limit=1), asm.assemble(asm.snapshot_states(system))


def _pair(sch, **kw):
    """(graphed, plain) block Cholesky solvers of the Schur's SC pattern."""
    args = (sch.sc_rows, sch.sc_cols, sch.asm.Np, sch.asm.Bp)
    return (GraphedBlockCholeskySolver(*args, device="cpu", **kw),
            BlockCholeskySolver(*args, device="cpu", **kw))


def _counts(rec):
    out = {}
    for c in rec["counts"]:
        if c.name.startswith("chol.graph"):
            out[c.name] = out.get(c.name, 0) + c.n
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("path", ["clique", "gathered"])
def test_graphed_solve_is_bitwise_the_plain_solve(ring, path, dtype):
    """Three LM trials through the Schur, the graphed reduced solver against
    the plain one on the same pattern: dx_p and dx_l bitwise equal, the held
    inputs keep their storage, and every call counts one
    ``chol.graph_eager.cpu``."""
    sch, bs = _schur(ring, dtype)
    if path == "gathered":
        sch.clique = False
    assert sch.clique == (path == "clique") and sch._clique_plan is not None
    graphed, plain = _pair(sch, bottom=BOTTOM)
    assert graphed.n_levels >= 2
    ptrs = set()
    timer.enable()
    for lam in DAMPING:
        d = damp_system(bs, bs.max_hdiag * lam, sch.asm.pp_diag_ids_dev)
        sch.reduced_chol = plain
        want = sch.solve(d)
        sch.reduced_chol = graphed
        got = sch.solve(d)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.isfinite(got[0]).all()
        ptrs.add(tuple(t.data_ptr() for held in graphed._held.values() for t in held))
    rec = timer.drain()
    assert len(ptrs) == 1 and len(graphed._held) == 1
    assert _counts(rec) == {"chol.graph_eager.cpu": len(DAMPING)}
    # each call factors and solves once, through every level
    factors = [s for s in rec["spans"] if s.name == "chol.factor"]
    assert len(factors) == 2 * len(DAMPING)
    levels = [s for s in rec["spans"] if s.name == "chol.level"]
    assert len(levels) == 2 * 3 * graphed.n_levels * len(DAMPING)


def _bottom_vertex(plan):
    """A vertex of the original numbering that reaches the dense bottom."""
    ids = np.arange(plan.N)
    for lv in plan.levels:
        ids = ids[lv.rest_orig]
    return int(ids[0])


def test_failed_first_rung_takes_the_plain_ladder(ring):
    """A float32 reduced system made indefinite at a bottom vertex: the
    graphed chain's first rung fails, the call counts one
    ``chol.graph_eager.ridge`` and answers with the plain solver's whole
    ladder, bitwise; a healthy system next counts none."""
    sch, bs = _schur(ring, torch.float32)
    graphed, plain = _pair(sch, bottom=BOTTOM)
    d = damp_system(bs, bs.max_hdiag * 1e-3, sch.asm.pp_diag_ids_dev)
    _c_inv, u, w, rhs = sch._sparse_w_rhs(d)
    sc = sch._sparse_sc(d, u, w)
    v = _bottom_vertex(graphed.plan)
    (i,) = np.flatnonzero((sch.sc_rows == v) & (sch.sc_cols == v))
    bad = sc.clone()
    blk = bad[i].reshape(6, 6)
    blk[0, 1] = blk[1, 0] = 2.0 * torch.sqrt(blk[0, 0] * blk[1, 1])
    timer.enable()
    got = graphed.solve(bad, rhs)
    rec = timer.drain()
    want = plain.solve(bad, rhs)
    # the plain ladder climbed past its first rung: more than one status read
    assert len([s for s in timer.drain()["spans"] if s.name == "host_sync"]) > 1
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert _counts(rec) == {"chol.graph_eager.cpu": 1, "chol.graph_eager.ridge": 1}
    timer.enable()
    assert torch.equal(graphed.solve(sc, rhs), plain.solve(sc, rhs))
    assert _counts(timer.drain()) == {"chol.graph_eager.cpu": 1}


def test_only_the_sparse_reduced_schur_is_graphed(ring, tmp_path):
    """The sparse-reduced Schur's reduced_chol is the graphed class; the
    dense Schur routes build none; FastL's, GN's and the distributed
    solver's block Cholesky stay the plain eager class."""
    sch, _ = _schur(ring, torch.float64)
    assert type(sch.reduced_chol) is GraphedBlockCholeskySolver
    dense = SchurSolver(sch.asm)
    assert dense.route != "sparse" and not hasattr(dense, "reduced_chol")
    poses, edges = D.make_manhattan_2d(n_poses=120, seed=3, loop_prob=0.3)
    p = str(tmp_path / "m120.g2o")
    D.write_g2o_2d(p, edges, poses)
    assert type(FastLSolver(parse_g2o(p), device="cpu").chol) is BlockCholeskySolver
    gn = GaussNewtonSolver(parse_g2o(p), device="cpu",
                           settings=SolverSettings(linear_solver="block_cholesky"))
    assert type(gn._sparse_chol) is BlockCholeskySolver
    assert not issubclass(DistributedBlockCholeskySolver, GraphedBlockCholeskySolver)
    assert DistributedBlockCholeskySolver.solve is BlockCholeskySolver.solve


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

#: ring871.batch's reduced camera system: 871 cameras, each covisible with
#: the 8 at ring offsets +-58, +-116, +-174, +-232 (4,355 blocks)
RING_N, RING_OFFSETS, RING_POINTS = 871, (58, 116, 174, 232), 20


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _ring871_pattern():
    i = np.arange(RING_N)
    pairs = [(i, i)] + [(i, (i + o) % RING_N) for o in RING_OFFSETS]
    rows = np.concatenate([np.minimum(a, b) for a, b in pairs])
    cols = np.concatenate([np.maximum(a, b) for a, b in pairs])
    return rows, cols


def _ring871_values(rows, cols, seed, dtype, device):
    """(blocks [4355, 36], eta [871, 6]): a reduced camera system of the
    pattern, summed from RING_POINTS random 2 x 6 Jacobians a camera, each
    point seen by the 5 cameras at offsets 0, 58, ..., 232 from it, then
    damped at 1e-3 x its largest diagonal entry."""
    rng = np.random.default_rng(seed)
    N, B = RING_N, 6
    offs = (0,) + RING_OFFSETS
    P = N * RING_POINTS
    cams = (np.repeat(np.arange(N), RING_POINTS)[:, None] + np.array(offs)[None, :]) % N
    J = rng.standard_normal((P, len(offs), 2, B)) * rng.uniform(0.1, 10.0, (P, 1, 1, 1))
    keys = rows * N + cols
    order = np.argsort(keys)
    blocks = np.zeros((len(rows), B, B))
    for a in range(len(offs)):
        for b in range(len(offs)):
            ca, cb = cams[:, a], cams[:, b]
            up = ca <= cb
            prod = np.einsum("pki,pkj->pij", J[up, a], J[up, b])
            want = ca[up] * N + cb[up]
            dst = order[np.searchsorted(keys[order], want)]
            assert np.array_equal(keys[dst], want)
            np.add.at(blocks, dst, prod)
    diag = np.flatnonzero(rows == cols)
    lam = 1e-3 * np.max(np.einsum("kii->ki", blocks[diag]))
    blocks[diag] += lam * np.eye(B)
    eta = rng.standard_normal((N, B))
    return (torch.as_tensor(blocks.reshape(-1, B * B), dtype=dtype, device=device),
            torch.as_tensor(eta, dtype=dtype, device=device))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_replay_is_bitwise_the_eager_chain(dtype):
    """On the card, ring871's reduced pattern (5 levels, a 464-block bottom):
    after the warm-up, three value sets replay the captured graph bitwise
    equal to the plain eager solve, with the capture raising nothing under
    the sync debug mode and the first rung never failing."""
    dev = _card()
    rows, cols = _ring871_pattern()
    graphed = GraphedBlockCholeskySolver(rows, cols, RING_N, 6, device=dev)
    plain = BlockCholeskySolver(rows, cols, RING_N, 6, device=dev)
    assert len(rows) == 4355 and graphed.n_levels == 5 and graphed.plan.n_bottom == 464
    timer.enable()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for seed in range(4):
            blocks, eta = _ring871_values(rows, cols, seed, dtype, dev)
            got = graphed.solve(blocks, eta)
            want = plain.solve(blocks, eta)
            assert torch.isfinite(want).all()
            assert torch.equal(got, want), f"value set {seed}"
    assert graphed.capture_failure is None and len(graphed._graphs) == 1
    assert _counts(timer.drain()) == {"chol.graph_eager.warm_up": 1,
                                      "chol.graph_captures": 1, "chol.graph_replays": 3}


@pytest.mark.card
def test_replays_count_every_call_after_the_warm_up():
    """On the card, traced: a warm-up, a capture, then a replay for every
    call; the chain's ``chol.level`` spans run at the warm-up and the
    capture only, and each call reads the status once."""
    dev = _card()
    rows, cols = _ring871_pattern()
    graphed = GraphedBlockCholeskySolver(rows, cols, RING_N, 6, device=dev)
    values = [_ring871_values(rows, cols, seed, torch.float32, dev) for seed in range(2)]
    calls = 6
    timer.enable()
    outs = [graphed.solve(*values[k % 2]) for k in range(calls)]
    rec = timer.drain()
    assert _counts(rec) == {"chol.graph_eager.warm_up": 1, "chol.graph_captures": 1,
                            "chol.graph_replays": calls - 1}
    levels = [s for s in rec["spans"] if s.name == "chol.level"]
    assert len(levels) == 2 * 3 * graphed.n_levels
    assert len([s for s in rec["spans"] if s.name == "chol.graph_replay"]) == calls - 1
    assert len([s for s in rec["spans"] if s.name == "host_sync"]) == calls
    # every call's dx is its own: the replays of one value set agree
    for k in range(2, calls):
        assert torch.equal(outs[k], outs[k - 2])
