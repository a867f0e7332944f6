"""Port parity for marginal covariance recovery, float64 on the CPU: every
route of Marginals, IncrementalMarginals (recompute, one Woodbury update,
repeated updates, the G columns of an edge batch), the block Cholesky's
recurrence, the compact-pose distances, the association step of the
data-association app and the CLI's -dm line, each against the JAX package
on the same seeded files (the sizes of tests/test_marginals.py; its
2,600-pose sparse case at 600 poses).
FastL's in-loop marginals are in tests/test_torch_incremental.py.

Both packages get the same lambda (the JAX package's, converted), so what
the comparisons see is the recovery alone.  Sigma = lambda^-1 of a SLAM
lambda is ill-conditioned (kappa 1e7-1e11 here): two correct float64
inversions differ by up to ~kappa x 1e-16 relative, and the JAX package
itself sits that far from numpy's dense inverse.  So the tolerance, x the
largest |entry| of the reference, is 1e-10 where kappa allows and is
named per case otherwise, with kappa and the measured distance beside it.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app import main as jmain
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.evaluation import distances as jdist
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.block_cholesky import BlockCholeskySolver as JChol
from slam_plus_plus_tpu.linalg.schur import SchurSolver as JSchur
from slam_plus_plus_tpu.marginals import Marginals as JMarginals
from slam_plus_plus_tpu.marginals.covariance import IncrementalMarginals as JIncMarg
from slam_plus_plus_tpu_torch.app import dataassoc_example
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem
from slam_plus_plus_tpu_torch.evaluation import distances as tdist
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver as TChol
from slam_plus_plus_tpu_torch.linalg import schur as tschur
from slam_plus_plus_tpu_torch.marginals import IncrementalMarginals, Marginals
from slam_plus_plus_tpu_torch.marginals.covariance import MAX_UPDATE_RANK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("marginals")
    out = {}

    def path(name):
        out[name] = str(d / f"{name}.g2o")
        return out[name]

    poses, edges = D.make_manhattan_2d(n_poses=60, seed=13)
    D.write_g2o_2d(path("m60"), edges, poses)
    poses, edges = D.make_manhattan_2d(n_poses=80, seed=33)
    D.write_g2o_2d(path("m80"), edges, poses)
    poses, edges = D.make_city_2d(n_poses=600, seed=31)
    D.write_g2o_2d(path("city600"), edges, poses)
    for name, kw in (("lm50_20", dict(n_poses=50, n_landmarks=20, seed=14)),
                     ("lm50_30", dict(n_poses=50, n_landmarks=30, seed=15)),
                     ("vp600", dict(n_poses=600, n_landmarks=90, world=35.0, obs_radius=9.0,
                                    seed=17))):
        _gp, _gl, pe, le = D.make_landmark_2d(**kw)
        D.write_g2o_landmark_2d(path(name), pe, le)
    D.write_g2o_ba(path("ba6_60"), *D.make_ba_scene(n_cams=6, n_points=60, seed=2))
    poses, edges = D.make_sphere_3d(n_poses=48, trans_noise=0.01, rot_noise=0.005, seed=4)
    D.write_g2o_3d(path("sphere48"), edges, poses)
    return out


def _rel(got, want):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _systems(path, flat):
    """(JAX assembler, port assembler, the JAX block system, the same as
    port tensors).  flat: the landmark files take the flat edge layout in
    both packages (the port's only layout for them)."""
    js, ts = jparse(path), tparse(path)
    ja = JAssembler(js, SolverConfig(edge_layout="flat", use_pallas="off") if flat
                    else SolverConfig(use_pallas="off"))
    ta = TAssembler(ts, device="cpu")
    jb = ja.assemble(ja.snapshot_states(js))
    tb = BlockSystem(*[torch.tensor(np.asarray(x)) for x in jb])
    return ja, ta, jb, tb


def _l_real(l_diag, asm):
    """The real tangent dims of each landmark block (padded dims mean
    nothing), stacked."""
    l_diag = l_diag.numpy() if isinstance(l_diag, torch.Tensor) else np.asarray(l_diag)
    Bl = asm.Bl
    return np.concatenate([l_diag[c].reshape(Bl, Bl)[np.ix_(m, m)].ravel()
                           for c, m in enumerate(asm.l_mask.astype(bool)[:asm.Nl])])


#: case -> (file, port mode, JAX mode, chunk, gauge jitter, route, tolerance).
#: Tolerances past 1e-10 (kappa of lambda; measured port-vs-JAX): city600
#: 1e-8 (1.0e10; 5.6e-9), vp600 1e-8 (6.0e9; 1.4e-9), m60 sparse 1e-9
#: (8.3e7; 1.5e-10).  Mono BA at the gauge jitter 1e-10 of the JAX BA facade
#: (app/ba_optimizer.py:123): 1e-3.  There both Schur routes, in both
#: packages, sit ~1e-4 from the true Sigma (port 1.0e-4, JAX 6.0e-5;
#: numpy's dense inverse of the whole lambda 1.1e-9 from it, kappa 2.9e8),
#: because SC = A_pp - U C^-1 U^T holds the scale gauge's eigenvalue,
#: jitter x max diag, as the difference of terms ~max diag: the cancellation
#: costs eps x 4.3e15 (|A_pp| + |U||C^-1||U^T| against SC's least
#: eigenvalue) in the worst case, not kappa x eps.  The port and the JAX
#: package differ by 1.6e-4 there (l_diag 5.1e-6); at jitter 1e-6 the
#: cancellation costs 5.8e-8 in the worst case and the routes hold 1e-10
#: (measured 1.2e-11).
ROUTES = {
    "dense": ("m60", "auto", "auto", None, 0.0, "dense", 1e-10),
    "sparse": ("m60", "sparse", "sparse", None, 0.0, "sparse", 1e-9),
    "sparse_600_poses": ("city600", "sparse", "sparse", None, 0.0, "sparse", 1e-8),
    "schur_flat": ("lm50_20", "auto", "auto", None, 0.0, "schur_flat", 1e-10),
    "schur_flat_chunks_of_8": ("lm50_30", "auto", "auto", 8, 0.0, "schur_flat", 1e-10),
    "sparse_schur": ("vp600", "sparse_schur", "sparse_schur", None, 0.0, "sparse_schur", 1e-8),
    "ba_uniform": ("ba6_60", "auto", "auto", None, 1e-10, "schur_uniform", 1e-3),
    "ba_sparse_schur": ("ba6_60", "sparse_schur", "sparse_schur", None, 1e-10,
                        "sparse_schur", 1e-3),
    "ba_uniform_jitter_1e-6": ("ba6_60", "auto", "auto", None, 1e-6, "schur_uniform", 1e-10),
    "ba_sparse_schur_jitter_1e-6": ("ba6_60", "sparse_schur", "sparse_schur", None, 1e-6,
                                    "sparse_schur", 1e-10),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_matches_jax(files, case, monkeypatch):
    """Each route against the JAX package's on the same lambda; the chunked
    case cuts the flat panels at 8 landmarks in both packages (the JAX
    package's test_marginals_schur_chunked)."""
    name, mode, jmode, chunk, jitter, route, tol = ROUTES[case]
    ja, ta, jb, tb = _systems(files[name], flat=name.startswith(("lm", "vp")))
    if chunk:
        monkeypatch.setattr(tschur, "_pick_chunk", lambda *_a: chunk)
    jm = JMarginals(ja, mode=jmode, gauge_jitter=jitter)
    tm = Marginals(ta, mode=mode, gauge_jitter=jitter)
    if chunk:
        import jax
        jm._schur = JSchur(ja, chunk=chunk)
        jm._compute_jit = jax.jit(jm._compute_impl)
        assert len(tm._schur._flat_chunks()) == -(-ta.Nl // chunk) >= 2
    assert tm.route == route
    want, got = jm.compute(jb), tm.compute(tb)
    assert got.p_diag.dtype == torch.float64 and got.p_diag.shape == want.p_diag.shape
    assert np.isfinite(np.asarray(want.p_diag)).all()
    assert _rel(got.p_diag, want.p_diag) <= tol
    if ta.Nl:
        assert _rel(_l_real(got.l_diag, ta), _l_real(want.l_diag, ta)) <= tol
    else:
        assert not got.l_diag.any()


def test_routes_agree_with_the_dense_inverse(files):
    """The two routes the smoke holds against each other on the BA scenes,
    here against the inverse of the jittered lambda on the small BA scene:
    numpy's, refined by Newton steps with long-double residuals (kappa of
    the equilibrated lambda 2.9e8; numpy's inverse sits 1.1e-9 from the
    refined one, tolerance 1e-8).  The uniform and the sparse-reduced Schur
    marginals agree with it at 1e-3 x scale (measured 1.0e-4: the Schur
    cancellation of ROUTES, its worst case eps x 4.3e15 here) and with
    each other, through the same SC, at 1e-7 (measured 3.6e-9, l_diag
    1.1e-10)."""
    _ja, ta, jb, tb = _systems(files["ba6_60"], flat=False)
    from slam_plus_plus_tpu_torch.linalg.bsr import partitioned_to_scipy
    A = partitioned_to_scipy(ta.pp_rows, ta.pp_cols, tb.pp_blocks.numpy(), ta.Np, ta.Bp,
                             ta.pl_rows, ta.pl_cols, tb.pl_blocks.numpy(), tb.ll_blocks.numpy(),
                             ta.Nl, ta.Bl).toarray()
    A += np.eye(len(A)) * float(tb.max_hdiag) * 1e-10
    d = 1.0 / np.sqrt(np.diag(A))
    E = (A * d[:, None] * d[None, :]).astype(np.longdouble)
    X = np.linalg.inv(A * d[:, None] * d[None, :]).astype(np.longdouble)
    for _ in range(3):
        X = X + X @ (np.eye(len(A), dtype=np.longdouble) - E @ X)
    S = (X * d[:, None] * d[None, :]).astype(np.float64)
    B = ta.Bp

    def p_blocks(S):
        return np.stack([S[i * B:(i + 1) * B, i * B:(i + 1) * B].ravel() for i in range(ta.Np)])

    ref = p_blocks(S)
    assert _rel(p_blocks(np.linalg.inv(A)), ref) <= 1e-8
    res = [Marginals(ta, mode=m, gauge_jitter=1e-10).compute(tb) for m in ("auto", "sparse_schur")]
    for r in res:
        assert _rel(r.p_diag, ref) <= 1e-3
    assert _rel(res[0].p_diag, res[1].p_diag) <= 1e-7
    assert _rel(_l_real(res[0].l_diag, ta), _l_real(res[1].l_diag, ta)) <= 1e-7


def _held_out(tmp_path, n, seed, hold, **kw):
    """A manhattan file whose last `hold` edges are loop closures (written
    in that order, not re-sorted), and its edge type."""
    poses, edges = D.make_manhattan_2d(n_poses=n, seed=seed, **kw)
    odo = [e for e in edges if abs(e[1] - e[0]) == 1]
    clo = [e for e in edges if abs(e[1] - e[0]) != 1]
    assert len(clo) >= hold
    p = str(tmp_path / f"held{n}.g2o")
    with open(p, "w") as f:
        for i, x in enumerate(poses):
            f.write(f"VERTEX2 {i} {x[0]:.10f} {x[1]:.10f} {x[2]:.10f}\n")
        for (i, j, z, info) in odo + clo:
            ut = [info[0, 0], info[0, 1], info[0, 2], info[1, 1], info[1, 2], info[2, 2]]
            f.write(f"EDGE2 {i} {j} " + " ".join(f"{v:.10f}" for v in z) + " " +
                    " ".join(f"{v:.10f}" for v in ut) + "\n")
    return p


#: case -> (poses, seed, loop_prob, held-out closures, route, tolerance):
#: tests/test_marginals.py's one update (manhattan 150, seed 16) and
#: repeated updates (120, seed 17, loop 0.5), and the repeated updates past
#: 1500 dims through the MIS-Schur factor (kappa 1e8-3e9; measured up to
#: 1.1e-9, 1.1e-9 and 6.6e-9; tests/test_marginals.py holds the first two
#: at 1e-8 and 1e-9 against a recompute).
INCREMENTAL = {
    "one_update": (150, 16, 0.1, 1, "dense", 1e-8),
    "repeated_updates": (120, 17, 0.5, 4, "dense", 1e-8),
    "repeated_updates_sparse": (600, 17, 0.5, 4, "sparse", 5e-8),
}


@pytest.mark.parametrize("case", list(INCREMENTAL))
def test_incremental_marginals_match_jax(tmp_path, case):
    """IncrementalMarginals: the recompute, then one Woodbury update per
    held-out closure against the cached factor (the dense factor, or the
    MIS-Schur one past 1500 dims, whose columns go through one multi-column
    solve): G per edge equal to the JAX package's (1e-12), the diagonal
    after the recompute and after each update against the JAX package's
    and against a from-scratch recompute of the grown lambda."""
    n, seed, loop, hold, route, tol = INCREMENTAL[case]
    p = _held_out(tmp_path, n, seed, hold, loop_prob=loop)
    js, ts = jparse(p), tparse(p)
    ja, ta = JAssembler(js), TAssembler(ts, device="cpu")
    jst, tst = ja.snapshot_states(js), ta.snapshot_states(ts)
    name = list(js.edge_stores)[0]
    counts = {name: js.edge_stores[name].n - hold}
    jb = ja.assemble_active(jst, counts, ja.Np, 0)
    tb = BlockSystem(*[torch.tensor(np.asarray(x)) for x in jb])
    jinc, tinc = JIncMarg(ja), IncrementalMarginals(ta)
    jinc.compute(jb)
    res = tinc.compute(tb)
    assert tinc._marg.route == route
    assert _rel(res.p_diag, jinc._sigma_diag) <= tol
    E = js.edge_stores[name].n
    for step in range(1, hold + 1):
        eidx = E - hold - 1 + step
        jG = JIncMarg.omega_sqrt_for_edges(ja, jst, name, [eidx])
        tG = IncrementalMarginals.omega_sqrt_for_edges(ta, tst, name, [eidx])
        assert _rel(tG, jG) <= 1e-12 and tinc.b_can_update(tG.shape[1])
        want = np.asarray(jinc.update(jG))
        got = tinc.update(tG)
        assert _rel(got, want) <= tol, step
        counts_now = {name: counts[name] + step}
        now = BlockSystem(*[torch.tensor(np.asarray(x)) for x in
                            ja.assemble_active(jst, counts_now, ja.Np, 0)])
        assert _rel(got, Marginals(ta).compute(now).p_diag) <= tol, step
    assert tinc._rank_used == 3 * hold
    too_many = tG.new_zeros((tG.shape[0], MAX_UPDATE_RANK - tinc._rank_used + 1))
    assert not tinc.b_can_update(too_many.shape[1])
    with pytest.raises(ValueError):
        tinc.update(too_many)


@pytest.mark.parametrize("name", ["m80", "sphere48"])
def test_edge_batch_columns_are_its_omega(files, name):
    """omega_sqrt_for_edges on a batch of the file's last 6 edges: each
    edge's columns where its own call puts them, and G G^T equal to what
    the 6 edges add to lambda in the assembler (IRLS-weighted on the robust
    SE(3) type), 1e-10 x scale."""
    ts = tparse(files[name])
    ta = TAssembler(ts, device="cpu")
    st = ta.snapshot_states(ts)
    (ename, store), = ts.edge_stores.items()
    batch = list(range(store.n - 6, store.n))
    G = IncrementalMarginals.omega_sqrt_for_edges(ta, st, ename, batch)
    one_by_one = [IncrementalMarginals.omega_sqrt_for_edges(ta, st, ename, [e]) for e in batch]
    assert torch.equal(G, torch.cat(one_by_one, dim=1))
    from slam_plus_plus_tpu_torch.linalg.bsr import partitioned_to_scipy

    def lam(count):
        bs = ta.assemble_active(st, {ename: count}, ta.Np, 0)
        return partitioned_to_scipy(ta.pp_rows, ta.pp_cols, bs.pp_blocks.numpy(), ta.Np,
                                    ta.Bp).toarray()

    assert _rel(G @ G.T, lam(store.n) - lam(store.n - 6)) <= 1e-10


@pytest.mark.parametrize("case", ["manhattan", "landmarks_mixed", "badly_scaled"])
def test_block_cholesky_marginals_match_jax(files, case):
    """BlockCholeskySolver.marginals (the recurrence over the MIS levels)
    on the same lambda as the JAX package's _marginals_impl, every block of
    the level-0 pattern: a manhattan graph; a landmark file in one mixed
    class, whose later-pose-to-earlier-landmark pairs are stored swapped
    (p_flip / u_flip); and that lambda scaled by D = 10^U(-3, 3) per
    scalar dim, against the JAX package and against D^-1 Sigma D^-1 of the
    unscaled recovery (the bottom equilibration and the level-0 Jacobi
    scaling are undone).  1e-8 x scale (kappa 1e9-1e10)."""
    name = "vp600" if case == "landmarks_mixed" else "city600"
    js = jparse(files[name])
    ja = JAssembler(js, SolverConfig(schur_split="off", edge_layout="flat"))
    jb = ja.assemble(ja.snapshot_states(js))
    blocks = np.asarray(jb.pp_blocks)
    N, B = ja.Np, ja.Bp
    if case == "badly_scaled":
        d = 10.0 ** np.random.default_rng(5).uniform(-3, 3, (N, B))
        outer = d[ja.pp_rows][:, :, None] * d[ja.pp_cols][:, None, :]
        base = blocks
        blocks = blocks * outer.reshape(len(blocks), B * B)
    kw = dict(bottom=64)
    jc = JChol(ja.pp_rows, ja.pp_cols, N, B, **kw)
    tc = TChol(ja.pp_rows, ja.pp_cols, N, B, device="cpu", **kw)
    assert len(tc.plan.levels) >= 3
    if case == "landmarks_mixed":
        assert all(lv.u_flip.any() for lv in tc.plan.levels)
    want = np.asarray(jc.marginals(jc.factor(jnp.asarray(blocks))))
    got = tc.marginals(tc.factor(torch.tensor(blocks)))
    assert _rel(got, want) <= 1e-8
    if case == "badly_scaled":
        sig0 = tc.marginals(tc.factor(torch.tensor(base))).numpy()
        rows0, cols0 = tc.plan.rows0, tc.plan.cols0
        unscale = 1.0 / (d[rows0][:, :, None] * d[cols0][:, None, :])
        assert _rel(got, sig0 * unscale.reshape(len(sig0), B * B)) <= 1e-8


# ---- distances and the data-association app ---------------------------------

def _pose_pair(rng):
    x = np.concatenate([rng.normal(0, 2, 3), rng.normal(0, 0.6, 3)])
    y = np.concatenate([rng.normal(0, 2, 3), rng.normal(0, 0.6, 3)])
    a, b = rng.normal(0, 0.1, (6, 6)), rng.normal(0, 0.1, (6, 6))
    return x, y, a @ a.T + 1e-3 * np.eye(6), b @ b.T + 1e-3 * np.eye(6), rng.normal(0, 0.01, (6, 6))


@pytest.mark.parametrize("with_cross", [False, True], ids=["block_diagonal", "cross_covariance"])
def test_distances_match_jax(with_cross):
    """relative_pose_distribution (without and with the cross-covariance),
    the rotation-magnitude transform, mahalanobis_distance2 and
    mahalanobis_gate on seeded poses and covariances, 1e-10 x scale."""
    for seed in (0, 1):
        x, y, sii, sjj, sij = _pose_pair(np.random.default_rng(seed))
        cross = sij if with_cross else None
        jm, js = jdist.relative_pose_distribution(x, y, sii, sjj, cross)
        tm, ts = tdist.relative_pose_distribution(x, y, sii, sjj, cross)
        assert _rel(tm, jm) <= 1e-10 and _rel(ts, js) <= 1e-10
        jm4, js4 = jdist.rotation_magnitude_transform(jm, js)
        tm4, ts4 = tdist.rotation_magnitude_transform(tm, ts)
        assert _rel(tm4, jm4) <= 1e-10 and _rel(ts4, js4) <= 1e-10
        assert (abs(tdist.mahalanobis_distance2(tm4, ts4) -
                    jdist.mahalanobis_distance2(jm4, js4))
                <= 1e-10 * jdist.mahalanobis_distance2(jm4, js4))
        for gate in ((1.0, 1.0, 1.0, 0.5), (0.1, 0.1, 0.1, 0.05)):
            assert (tdist.mahalanobis_gate(tm4, ts4, np.array(gate)) ==
                    jdist.mahalanobis_gate(jm4, js4, np.array(gate)))
    assert _rel(tdist.rotation_magnitude_transform(np.zeros(6), np.eye(6))[1],
                jdist.rotation_magnitude_transform(np.zeros(6), np.eye(6))[1]) == 0.0


def test_association_decisions_match_jax(files):
    """run_association on a 48-pose sphere: each candidate's mean4, squared
    distance and decision against the JAX package's association step (its
    distance functions, transform and gate, as its run_association applies
    them) over the port's maintained posterior and solved poses.  (The JAX
    package's own FastL maintains a different posterior on SE(3) graphs:
    see test_inloop_updates_on_se3_equal_a_recompute.)"""
    system = tparse(files["sphere48"])
    n = len(system.vertex_order)
    query = system.vertex_order[-1]
    candidates = system.vertex_order[:-1][::max(1, n // 12)]
    decisions, sv = dataassoc_example.run_association(system, query, candidates, device="cpu")
    sig = sv.sigma_diag().numpy()
    asm = sv.asm

    def pose_and_sigma(gid):
        tname, li = system.vertex_directory[gid]
        return system.vertex_stores[tname].data[li], sig[int(asm.type_cslot[tname][li])]

    xq, sq = pose_and_sigma(query)
    accepted = 0
    for (cid, m4, ok, d2) in decisions:
        xc, sc = pose_and_sigma(cid)
        jm4, js4 = jdist.rotation_magnitude_transform(
            *jdist.relative_pose_distribution(xq, xc, sq, sc))
        js4 = js4 + 1e-9 * np.eye(4)
        assert _rel(m4, jm4) <= 1e-10
        assert abs(d2 - jdist.mahalanobis_distance2(jm4, js4)) <= 1e-9 * d2
        assert ok == jdist.mahalanobis_gate(jm4, js4, np.array((1.0, 1.0, 1.0, 0.5)))
        accepted += ok
    assert 0 < accepted < len(decisions)
    assert sv.marginals_trace.count("update") >= 20


def test_cli_marginals_line_matches_jax(files, capsys):
    """-dm prints the JAX CLI's line after the solve (a pose graph, the
    dense route, and a landmark file, the Schur route)."""
    for name, route in (("m60", "dense"), ("lm50_20", "schur_flat")):
        path = files[name]
        assert jmain.main(["-i", path, "-dm", "-dx", "", "-nb", "-s"]) == 0
        want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("marginals:")]
        args = tmain.build_argparser().parse_args(["-i", path, "-dm", "-dx", "", "-s",
                                                   "--device", "cpu"])
        _chi2, _it, solver = tmain.run(args)
        got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("marginals:")]
        marg, _bs, _res, line = solver.marginals_report
        assert got == want == [line] and marg.route == route
