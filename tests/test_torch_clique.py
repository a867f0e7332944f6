"""The sparse-reduced Schur's clique path through K3 (ops/clique.py): the host
plan, the plain versions against the solver's torch chain, the solve's
counters, and K3a's least work by real observations.

The ``card`` test holds K3a and K3b to their plain versions at ring871's
and venice-real's cliques (chip_smoke.py's inputs) and at every lane layout
of K3a; it skips without a card and runs there by

    python -m pytest --noconftest -m card tests/test_torch_clique.py

(the repository's conftest imports JAX, which the card's machine lacks).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import roofline
from benchmark.clique_work import clique_work
from benchmark.spec import Spec
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
from slam_plus_plus_tpu_torch.ops import clique as k3
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver, damp_system
from slam_plus_plus_tpu_torch.utils import timer

#: the blocks of mono BA: camera 6, point 3
BP, BL = 6, 3


@pytest.fixture(autouse=True)
def _tracer_off():
    timer.disable()
    timer.drain()
    yield
    timer.disable()
    timer.drain()


def _scene_file(path, M, flipped, n_cams=24, n_points=400, seed=5):
    """A BA file whose every point is seen M times; "sorted" writes each
    point's observations by rising camera, so no pair needs the flip."""
    cams, pts, obs = D.make_ba_scene_large(n_cams=n_cams, n_points=n_points,
                                           obs_per_point=M, seed=seed)
    if not flipped:
        obs = sorted(obs, key=lambda o: (o[0], o[1]))
    D.write_g2o_ba(path, cams, pts, obs)
    return path


def _solver(path):
    """(the forced sparse-reduced SchurSolver, its damped float64 system)."""
    system = parse_g2o(path)
    asm = Assembler(system, device="cpu")
    bs = asm.assemble(asm.snapshot_states(system))
    bs = damp_system(bs, bs.max_hdiag * 1e-3, asm.pp_diag_ids_dev)
    return SchurSolver(asm, sparse_reduced_limit=1), bs


def _rel(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-300)


@pytest.mark.parametrize("flipped", [False, True], ids=["sorted", "flipped"])
@pytest.mark.parametrize("M", [2, 5, 6])
def test_plain_versions_equal_the_torch_chain(tmp_path, M, flipped):
    """K3's plain versions against the solver's torch clique chain
    (_sparse_w_rhs + _sparse_sc, _sparse_back_substitute), float64, to
    1e-12 x scale: with the plan's CTAs and with CTAs of 7 landmarks, which
    split every tuple's run into pieces."""
    sch, bs = _solver(_scene_file(str(tmp_path / "s.g2o"), M, flipped))
    assert sch.sparse_reduced and sch.clique and sch.M == M
    assert bool(sch.fill_flip.any()) == flipped
    c_inv, u, w, rhs = sch._sparse_w_rhs(bs)
    sc = sch._sparse_sc(bs, u, w)
    dx_p = sch._sparse_factor_solve(sc, rhs)
    _, dx_l = sch._sparse_back_substitute(bs, c_inv, u, dx_p)
    plans = [sch._clique_plan,
             k3.build_clique_plan(sch.asm.pl_rows.reshape(-1, M), sch.fill_dst, sch.pp_to_sc,
                                  sch.Ksc, sch.asm.Np, "cpu", per_cta=7)]
    assert plans[1].n_pieces > plans[0].n_pieces
    for plan in plans:
        got = k3.clique_forward_plain(bs.ll_blocks, bs.eta_l, u, bs.eta_p, bs.pp_blocks, plan)
        for g, want in zip(got, (c_inv, sc, rhs)):
            assert g.shape == want.shape and _rel(g, want) <= 1e-12
        assert _rel(k3.clique_back_plain(c_inv, u, bs.eta_l, dx_p, plan), dx_l) <= 1e-12


def test_plan_groups_tuples_into_pieces(tmp_path):
    """The permutation orders the landmarks by camera tuple; a piece is one
    tuple's run inside one CTA; every pair block and rhs vector of every
    piece lies in exactly one segment, the one of its SC block or camera."""
    sch, _ = _solver(_scene_file(str(tmp_path / "s.g2o"), 5, True))
    M, T, Nl = 5, 15, sch.asm.Nl
    rows = sch.asm.pl_rows.reshape(Nl, M)
    plan = k3.build_clique_plan(rows, sch.fill_dst, sch.pp_to_sc, sch.Ksc, sch.asm.Np, "cpu",
                                per_cta=64)
    perm, piece = plan.perm.numpy(), plan.piece.numpy()
    assert np.array_equal(np.sort(perm), np.arange(Nl))
    rs = rows[perm]
    keys = [tuple(r) for r in rs]
    assert keys == sorted(keys)
    assert np.all(np.diff(piece) >= 0) and piece[0] == 0 and piece[-1] == plan.n_pieces - 1
    for p in range(plan.n_pieces):
        at = np.flatnonzero(piece == p)
        assert len({a // 64 for a in at}) == 1                  # one CTA
        assert (rs[at] == rs[at[0]]).all()                       # one tuple
    assert plan.n_partials == plan.n_pieces * T
    dst = sch.fill_dst.reshape(Nl, T)[perm[np.searchsorted(piece, np.arange(plan.n_pieces))]]
    src, off = plan.sc_src.numpy(), plan.sc_off.numpy()
    assert sorted(src) == list(range(plan.n_partials))
    for s in range(sch.Ksc):
        assert (dst.reshape(-1)[src[off[s]:off[s + 1]]] == s).all()
    assert sorted(plan.rhs_src.numpy()) == list(range(plan.n_pieces * M))
    assert plan.rhs_off.numpy()[-1] == plan.n_pieces * M
    pp_of = plan.pp_of_sc.numpy()
    assert np.array_equal(pp_of[sch.pp_to_sc], np.arange(len(sch.pp_to_sc)))
    assert (pp_of >= 0).sum() == len(sch.pp_to_sc)


def test_tuple_order_falls_back_to_lexsort():
    """Tuples too wide for one int64 key sort by lexsort, with the same
    order."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 3, (200, 4))
    wide = rows * (1 << 20)
    np.testing.assert_array_equal(k3.tuple_order(rows), k3.tuple_order(wide))
    np.testing.assert_array_equal(k3.tuple_order(rows), np.lexsort(rows.T[::-1]))


def test_kernel_shapes_and_the_gathered_path(tmp_path):
    """K3 takes 6 x 3 blocks up to degree 10; the gathered path (clique
    False) keeps the torch chain and counts no K3 solve."""
    assert k3.supported(5, 6, 3) and k3.supported(10, 6, 3)
    assert not k3.supported(11, 6, 3) and not k3.supported(5, 7, 3)
    assert not k3.supported(5, 6, 1)
    sch, bs = _solver(_scene_file(str(tmp_path / "s.g2o"), 5, True))
    want = sch.solve(bs)
    sch.clique = False
    timer.enable()
    got = sch.solve(bs)
    counts = {c.name for c in timer.drain()["counts"]}
    assert not counts & {"schur.clique.plain", "schur.clique.kernel"}
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10


def test_counters_count_per_solve(tmp_path):
    """LM through the clique path on the CPU: ``schur.clique.plain`` once
    a solve, ``schur.clique.partials`` the plan's partial blocks a solve,
    no ``schur.clique.kernel``; K3a inside ``schur.sc_fill``."""
    lm = LevenbergMarquardtSolver(parse_g2o(_scene_file(str(tmp_path / "s.g2o"), 5, True)),
                                  device="cpu")
    lm._schur = SchurSolver(lm.asm, sparse_reduced_limit=1)
    timer.enable()
    lm.optimize(3, 0.01)
    rec = timer.drain()
    solves = [s for s in rec["spans"] if s.name == "schur.solve"]
    by_id = {s.id: s for s in rec["spans"]}
    plain = [c for c in rec["counts"] if c.name == "schur.clique.plain"]
    partials = [c for c in rec["counts"] if c.name == "schur.clique.partials"]
    assert len(solves) >= 2 and len(plain) == len(partials) == len(solves)
    assert all(by_id[c.span].name == "schur.solve" for c in plain)
    assert {c.n for c in partials} == {lm._schur._clique_plan.n_partials}
    assert not [c for c in rec["counts"] if c.name == "schur.clique.kernel"]
    assert len([s for s in rec["spans"] if s.name == "schur.sc_fill"]) == len(solves)


def test_k3_least_work_and_reader():
    """K3a's least work at ring871's counts (2,637,400 observations): each
    3 x 6 block read once with its camera id, float32 200.4 MB at 3.35
    TB/s = 0.0598 ms, bound by bytes; the reader divides it by K3a's device
    time a launch (its pass and its sum) and says nothing without K3a."""
    n = 527480 * 5
    nbytes, flops = clique_work(n, 4)
    assert nbytes == n * (18 * 4 + 4) and flops == n * 2 * 3 * 3 * 6
    least, by = roofline.least_seconds(nbytes, flops, 4)
    assert by == "bytes" and least * 1e3 == pytest.approx(0.0598, abs=5e-5)
    read = Spec().reader("k3_roofline_pct")

    def ctx(n_fwd, fwd_s, sum_s):
        table = {"clique_fwd_kernel": (n_fwd, fwd_s), "clique_sum_kernel": (n_fwd, sum_s)}
        trace = SimpleNamespace(kernels=lambda pattern: table.get(pattern, (0, 0.0)))
        return SimpleNamespace(trace=trace, counts={"observations": n}, itemsize=4)

    assert read(ctx(0, 0.0, 0.0)) is None
    assert read(ctx(5, 5 * 1.5 * least, 5 * 0.5 * least)) == pytest.approx(50.0)
    spec = Spec()
    (m,) = [m for m in spec.data["per_layer"] if m["name"] == "k3_roofline_pct"]
    assert m["workloads"] == ["ring871.batch"] and m["moves"] == "solve_ms"
    assert m in spec.per_layer("ring871.batch") and m not in spec.per_layer("ring89.batch")


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

CARD_SEED = 3_141_592_653
#: (Nl, M, cameras, ring tuples) of the card test: ring871's clique (the
#: benchmark cell's), venice-real's (chip_smoke.py phase 8), and every lane
#: layout of K3a (16 lanes a pair at M <= 5, 8 at M 6-7, 4 at M 8-10) with
#: long runs of one tuple (ring) or a tuple per landmark
CARD_SHAPES = {"ring871": chip_smoke.K3_RING871 + (True,),
               "venice-real": chip_smoke.K3_VENICE + (True,),
               "M2-distinct": (60000, 2, 871, False), "M6-ring": (60000, 6, 871, True),
               "M10-distinct": (60000, 10, 871, False)}


def test_card_shapes_cover_every_lane_layout(tmp_path):
    """The card test's cliques, built on the CPU at a small size: their
    SC pattern is the solver's (fill_dst, pp_to_sc, Ksc, the flip where a
    pair runs against the order) on a scene with the same camera ids, ring
    tuples share long runs, distinct ones give nearly a piece a landmark."""
    for name, (_Nl, M, n_cams, ring) in CARD_SHAPES.items():
        rows = chip_smoke.clique_rows(2000, M, n_cams, 7, ring)
        assert rows.shape == (2000, M) and rows.min() >= 0 and rows.max() < n_cams
        assert all(len(set(r)) == M for r in rows.tolist()), name
        plan = k3.build_clique_plan(rows, *chip_smoke.clique_pattern(rows, n_cams), n_cams,
                                    "cpu")
        assert (plan.n_pieces < 2000 * 0.6) == ring, name
    assert {M for (_, M, _, _) in CARD_SHAPES.values()} == {2, 5, 6, 8, 10}
    sch, _ = _solver(_scene_file(str(tmp_path / "s.g2o"), 5, True))
    rows = sch.asm.pl_rows.reshape(sch.asm.Nl, 5)
    fill_dst, pp_to_sc, Ksc = chip_smoke.clique_pattern(rows, sch.asm.Np)
    assert Ksc == sch.Ksc
    np.testing.assert_array_equal(fill_dst, sch.fill_dst)
    np.testing.assert_array_equal(pp_to_sc, sch.pp_to_sc)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)],
                         ids=["float32", "float64"])
def test_k3_full_shape_matches_its_plain_versions(dtype, tol, shape):
    """On the card: K3a's C^-1, SC and rhs and K3b's dx_l against the plain
    versions, within tol x scale; two calls equal bit for bit (the
    fixed-order sums); one launch each a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    Nl, M, n_cams, ring = CARD_SHAPES[shape]
    rows = chip_smoke.clique_rows(Nl, M, n_cams, CARD_SEED, ring)
    plan, ll, eta_l, u, eta_p, pp = chip_smoke.clique_inputs(torch, dev, dtype, rows, n_cams,
                                                             CARD_SEED)
    f0, b0 = k3.clique_forward.launches, k3.clique_back.launches
    got = k3.clique_forward(ll, eta_l, u, eta_p, pp, plan)
    again = k3.clique_forward(ll, eta_l, u, eta_p, pp, plan)
    torch.cuda.synchronize()
    assert k3.clique_forward.launches == f0 + 2
    want = k3.clique_forward_plain(ll, eta_l, u, eta_p, pp, plan)
    for name, x, y, z in zip(("c_inv", "sc", "rhs"), got, again, want):
        err = _rel(x, z)
        print(f"{shape} {dtype} {name}: {err:.3e} x scale; pieces {plan.n_pieces}, partials "
              f"{plan.n_partials} of {Nl * plan.T} pair products")
        assert torch.equal(x, y) and err <= tol
    dx_p = torch.randn(eta_p.shape, device=dev, dtype=dtype)
    c_inv = want[0]
    dx_l = k3.clique_back(c_inv, u, eta_l, dx_p, plan)
    torch.cuda.synchronize()
    assert k3.clique_back.launches == b0 + 1
    err = _rel(dx_l, k3.clique_back_plain(c_inv, u, eta_l, dx_p, plan))
    print(f"{shape} {dtype} dx_l: {err:.3e} x scale")
    assert err <= tol
    assert torch.equal(dx_l, k3.clique_back(c_inv, u, eta_l, dx_p, plan))
