"""Port parity for incremental SLAM, float64 on the CPU: the device vertex
initializers and the active-prefix assembly against the JAX package; the
maintained factor's flat stores after the first dirty step against the JAX
package's FastLSolver (dirty refresh, its JAX engine) on the same file;
the capacity overflow to the full redescent, against the JAX package's
full-refresh replay; the construction's walks against the JAX package's
per-point walk, and the replay's use of them; the incremental lambda
solver's reference goldens on its delegated and its own path, and its own
path on a Sim(3) chain (blocks 7 wide) against the JAX package's; an SE(3)
ternary-edge replay; the CLI's -nsp / -fL / error lines; and FastL's
in-loop marginals against the JAX package's and against a recompute.

Tolerances: 1e-12 x scale for arithmetic done the same way in both
packages (initializers, assembly); 1e-10 x scale for the factor stores; and
1e-8 for what passes through two packages' factorizations (the bottom's
Cholesky factor, a replay's final chi2).  Goldens (tests/test_golden_parity.py:99-128, the
reference binary's `-nsp 1`): chi2 to 0.01, iterations exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app import main as jmain
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import MarginalsPolicy as JPolicy
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem as JSystem
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.models.types import EDGE_TYPES as JEDGES
from slam_plus_plus_tpu.solvers.fastl import FastLSolver as JFastL
from slam_plus_plus_tpu.solvers.incremental import IncrementalSolver as JInc
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.graph.system import GraphSystem as TSystem
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.incremental_cholesky import IncrementalCholesky
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES as TEDGES
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver as TFastL
from slam_plus_plus_tpu_torch.solvers import incremental
from slam_plus_plus_tpu_torch.solvers.incremental import IncrementalSolver

_INFO6 = " ".join(["20 0 0 0 0 0 20 0 0 0 0 20 0 0 0 20 0 0 20 0 20"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("incremental")
    out = {}

    def path(name):
        out[name] = str(d / f"{name}.g2o")
        return out[name]

    poses, edges = D.make_manhattan_2d(n_poses=300, seed=91)
    D.write_g2o_2d(path("manhattan300_91"), edges, poses)
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=1)
    D.write_g2o_2d(path("manhattan300_1"), edges, poses)
    poses, edges = D.make_manhattan_2d(n_poses=160, seed=5, loop_prob=0.4)
    D.write_g2o_2d(path("manhattan160"), edges, poses)
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=92, loop_prob=0.3)
    D.write_g2o_2d(path("m300_92"), edges, poses)
    poses, edges = D.make_sphere_3d(n_poses=48, trans_noise=0.01, rot_noise=0.005, seed=4)
    D.write_g2o_3d(path("sphere48"), edges, poses)
    _gp, _gl, pe, le = D.make_landmark_2d(n_poses=150, n_landmarks=60, seed=3)
    D.write_g2o_landmark_2d(path("landmarks150"), pe, le)
    poses, edges = D.make_sphere_3d(n_poses=40, trans_noise=0.02, rot_noise=0.01, seed=11)
    p = path("ternary40")
    D.write_g2o_3d(p, edges, poses)
    n = tparse(p).num_vertices
    with open(p, "a") as f:
        for i in range(0, n - 2, 3):
            f.write(f"EDGE3:TERNARY {i} {i+1} {i+2} 0 0 0 0 0 0 {_INFO6}\n")
    return out


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("ename, slot", [
    ("edge_pose2d", 0), ("edge_pose2d", 1), ("edge_pose_landmark2d", 1),
    ("edge_pose3d", 1), ("edge_pose3d_ternary", 1), ("edge_pose3d_ternary", 2),
    ("edge_pose_landmark3d", 1)])
def test_device_initializer_matches(ename, slot):
    """Each ported device initializer against the JAX jax_initializer on the
    same seeded states and measurements."""
    rng = np.random.default_rng(7)
    tet, jet = TEDGES[ename], JEDGES[ename]
    dims = {"pose2d": 3, "landmark2d": 2, "pose3d": 6, "landmark3d": 3}
    states = [rng.normal(size=(5, dims[t])) * 0.7 for t in tet.vertex_types]
    z = rng.normal(size=(5, tet.measurement_dim)) * 0.7
    got = tet.device_initializer(tuple(torch.tensor(s) for s in states), torch.tensor(z), slot)
    want = jax.vmap(lambda *a: jet.jax_initializer(a[:-1], a[-1], slot))(
        *[jnp.asarray(s) for s in states], jnp.asarray(z))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name", ["manhattan160", "landmarks150"])
def test_assemble_active_matches(files, name):
    """The active-prefix block system and chi2 at a mid-replay prefix (the
    first half of each edge type, the first 40 vertices active) against
    the JAX package's, with the JAX FastL's settings (one mixed class, flat
    layout)."""
    path = files[name]
    js, ts = jparse(path), tparse(path)
    jasm = JAssembler(js, SolverConfig(schur_split="off", edge_layout="flat"))
    tasm = TAssembler(ts, device="cpu",
                      settings=SolverSettings(schur_split="off", edge_layout="flat"))
    counts = {n: st.n // 2 for n, st in ts.edge_stores.items()}
    want = jasm.assemble_active(jasm.snapshot_states(js), counts, 40, 0)
    got = tasm.assemble_active(tasm.snapshot_states(ts), counts, 40, 0)
    for field in ("pp_blocks", "eta_p", "chi2"):
        assert _rel(getattr(got, field), getattr(want, field)) <= 1e-12, field
    assert _rel(tasm.chi2_active(tasm.snapshot_states(ts), counts),
                jasm.chi2_active(jasm.snapshot_states(js), counts)) <= 1e-12


def test_assemble_active_refuses_uniform_layout(tmp_path):
    cams, pts, obs = D.make_ba_scene(n_cams=4, n_points=30, seed=2)
    p = str(tmp_path / "ba.g2o")
    D.write_g2o_ba(p, cams, pts, obs)
    asm = TAssembler(tparse(p), device="cpu")
    assert asm.pl_uniform is not None
    with pytest.raises(RuntimeError, match="edge_layout"):
        asm.assemble_active(asm.snapshot_states(tparse(p)), {"edge_p2c": 1}, 1, 1)


def _dirty_stores_jax(fl):
    """Wrap the JAX engine's two dirty-step programs (the fused solve point
    and the standalone step) to keep the stores after every call."""
    seen = []

    def keep(out):
        seen.append({k: np.asarray(v) for k, v in out.items()})

    for en, fn in list(fl._fused1_fns.items()):
        def fused(*a, fn=fn):
            res = fn(*a)
            keep(res[0])
            return res
        fl._fused1_fns[en] = fused
    step = fl.inc._step_jit

    def step_spy(*a):
        res = step(*a)
        keep(res[0])
        return res
    fl.inc._step_jit = step_spy
    return seen


def _dirty_stores_port(fl):
    """Keep a copy of the stores after every dirty step (the step updates
    them in place)."""
    seen = []
    scan = fl.inc._dirty_scan

    def spy(stores, *a):
        out = scan(stores, *a)
        seen.append({k: v.clone() for k, v in out.items()})
        return out
    fl.inc._dirty_scan = spy
    return seen


@pytest.mark.parametrize("name", ["manhattan160", "landmarks150"])
def test_dirty_stores_match_jax(files, name):
    """The flat factor stores after every dirty step of the replay (every
    row of H — each level's off-diagonal pair blocks included, where a
    wrong transpose on store would show: an edge from a later pose to an
    earlier landmark is stored swapped — C, W, P, the dense bottom and its
    factor), their DUMMY rows left zero, and the final chi2, against the
    JAX package's engine."""
    path = files[name]
    jfl = JFastL(jparse(path), every_n=1, refresh="dirty", use_native=False)
    jseen = _dirty_stores_jax(jfl)
    jchi2, jit = jfl.run()
    tfl = TFastL(tparse(path), device="cpu")
    tseen = _dirty_stores_port(tfl)
    chi2, it = tfl.run()
    inc = tfl.inc
    assert len(tfl.chol.plan.levels) >= 2
    if name == "landmarks150":
        assert any(w.any() for plan in tfl.asm.plans for (_a, _b, _s, w) in plan.pp_contribs)
    assert (inc.KH, inc.NC, inc.NW, inc.NP) == (jfl.inc.KH, jfl.inc.NC, jfl.inc.NW, jfl.inc.NP)
    assert len(tseen) == len(jseen) > 10
    rows = {"H": inc.KH, "C": inc.NC, "W": inc.NW, "P": inc.NP}
    for got, want in zip(tseen, jseen):
        for k, n in rows.items():
            assert _rel(got[k][:n], want[k][:n]) <= 1e-10, k
        for k in ("s", "sv"):
            assert _rel(got[k], want[k]) <= 1e-10, k
        assert _rel(got["dense"][:-1], want["dense"][:-1]) <= 1e-10
        # the bottom's Cholesky factor passes through two factorizations
        assert _rel(got["L"], want["L"]) <= 1e-8
        for k, dummy in (("H", inc.H_dummy), ("C", inc.C_dummy), ("W", inc.W_dummy),
                         ("P", inc.P_dummy)):
            assert not got[k][dummy].any(), f"{k} DUMMY row written"
    # the off-diagonal pair blocks carry weight in the comparison
    offd = np.flatnonzero(inc.plan.rows0 != inc.plan.cols0)
    H0 = jseen[0]["H"]
    assert np.abs(H0[offd]).max() > 1e-3 * np.abs(H0[:inc.KH]).max()
    assert it == jit and abs(chi2 - jchi2) <= 1e-8 * jchi2


def test_plan_without_levels_keeps_h_equal_to_the_bottom(tmp_path):
    """A graph no larger than the bottom has no elimination level, so its
    level-0 blocks ARE the bottom pattern: after a dirty step the H store
    must still equal the dense bottom's blocks.  (The JAX module adds the
    deltas to those rows a second time: ROADMAP.md Queue 3.)"""
    poses, edges = D.make_manhattan_2d(n_poses=30, seed=5, loop_prob=0.4)
    p = str(tmp_path / "m30.g2o")
    D.write_g2o_2d(p, edges, poses)
    fl = TFastL(tparse(p), device="cpu")
    assert not fl.chol.plan.levels
    seen = _dirty_stores_port(fl)
    fl.run()
    st, inc, plan = seen[0], fl.inc, fl.chol.plan
    nb = plan.n_bottom * fl.asm.Bp
    blocks = st["dense"][:-1].reshape(nb * nb)[torch.as_tensor(plan._bottom_idx)]
    assert _rel(st["H"][:inc.KH], blocks) <= 1e-14


@pytest.mark.parametrize("case", ["tiny_capacities", "tiny_capacities_landmarks"])
def test_full_redescents_end_where_the_full_refresh_ends(files, case):
    """Solve points that take the full redescent inside a dirty replay —
    capacity overflows forced by tiny capacities, counted in stats — end
    the replay where the JAX package's full-refresh replay (its JAX
    engine) ends (manhattan 300: 8 iterations; landmarks 150/60, where a
    step reaches landmark rows)."""
    path = files["landmarks150" if case.endswith("landmarks") else "manhattan300_91"]
    full = JFastL(jparse(path), every_n=1, refresh="full", use_native=False)
    want, want_it = full.run()
    fl = TFastL(tparse(path), device="cpu")
    fl.inc = IncrementalCholesky(fl.chol, caps=dict(d=8, e=2, w=4, p=4))
    fl._walk_schedule()
    chi2, it = fl.run()
    assert fl.stats["dirty_overflows"] > 0
    assert fl.stats["full_refactors"] > full.stats["full_refactors"]
    assert it == want_it and abs(chi2 - want) <= 1e-8 * want
    if not case.endswith("landmarks"):
        assert it == 8


def test_prepare_host_matches_the_batch_walk(files):
    """The construction's batch walk gives, at every solve point of a
    replay, what the JAX package's per-point reachability walk
    (IncrementalCholesky.prepare_host) packs on the same plan."""
    path = files["landmarks150"]
    jfl = JFastL(jparse(path), every_n=1, refresh="dirty", use_native=False)
    fl = TFastL(tparse(path), device="cpu")
    inc, jinc = fl.inc, jfl.inc
    # the same plan, capacities and slot layout, and the same schedule
    assert len(fl.chol.plan.levels) >= 2
    assert (inc.KH, inc.NC, inc.NW, inc.NP) == (jinc.KH, jinc.NC, jinc.NW, jinc.NP)
    assert ((inc.cap_d, inc.cap_e, inc.cap_w, inc.cap_p) ==
            (jinc.cap_d, jinc.cap_e, jinc.cap_w, jinc.cap_p))
    assert inc._slots == jinc._slots
    assert sorted(fl._sched) == sorted(jfl._sched) == sorted(fl._prepared_all)
    assert len(fl._prepared_all) > 100
    n_over = 0
    for si, packed in fl._prepared_all.items():
        assert all(np.array_equal(a, b) for a, b in zip(fl._sched[si], jfl._sched[si]))
        one = jinc.prepare_host(jfl._sched[si])
        assert (one is None) == (packed is None)
        if packed is None:
            n_over += 1
            continue
        for a, b in zip(one, packed):
            assert np.array_equal(a, b)
    assert n_over < len(fl._prepared_all)


@pytest.mark.parametrize("name", ["manhattan300_91", "landmarks150"])
def test_every_solve_point_takes_its_walk_from_construction(files, name):
    """Every solve point with pending edges takes the walk construction
    planned for it: the runner gets exactly the planned walks, in order,
    and each point planned None (an overflow) takes the full redescent;
    the replay walks nothing of its own."""
    fl = TFastL(tparse(files[name]), device="cpu")
    planned = [fl._prepared_all[si] for si in sorted(fl._prepared_all)]
    assert planned and len(planned) == len(fl._sched)
    got = []
    inner, absorb = fl._solve_point, fl.absorb

    def solve_point(chunks, hp):
        got.append(hp)
        return inner(chunks, hp)

    def absorb_spy(stores, eta0, states, pending, walk):
        got.append(walk)
        return absorb(stores, eta0, states, pending, walk)

    def no_walk(pending):
        raise AssertionError("the replay walked a solve point")

    fl._solve_point, fl.absorb, fl.walk = solve_point, absorb_spy, no_walk
    fl.run()
    # the trailing edges' redescent, where there are any, comes last
    tail = len(got) - len(planned)
    assert tail in (0, 1) and all(w is None for w in got[len(planned):])
    assert all(g is p for g, p in zip(got, planned))
    assert fl.stats["omega_steps"] == len(planned)
    assert fl.stats["dirty_overflows"] == sum(p is None for p in planned)


@pytest.mark.parametrize("case", ["manhattan_delegated", "manhattan_own_path",
                                  "manhattan_own_path_scipy", "landmarks_delegated"])
def test_incremental_lambda_golden(files, case, monkeypatch):
    """`-nsp 1` goldens: manhattan 300 seed 1, 1980.14 @ 30, through the
    maintained-factor engine and through the solver's own path (the dense
    direct factor, with the delegation turned off, or the host scipy
    oracle, which the engine does not serve); landmarks 150/60 seed 3,
    24.65 @ 166."""
    name, golden = (("landmarks150", (24.65, 166)) if case.startswith("landmarks")
                    else ("manhattan300_1", (1980.14, 30)))
    own = "own_path" in case
    scipy = case.endswith("scipy")
    if own and not scipy:
        monkeypatch.setattr(incremental, "takes_fastl", lambda system, settings: False)
    inc = IncrementalSolver(tparse(files[name]), device="cpu", settings=SolverSettings(
        linear_solver="scipy" if scipy else "auto"))
    assert (inc._delegate is None) == own
    if own:
        assert inc._schur is None and inc._dense == (not case.endswith("scipy"))
    chi2, iters = inc.run()
    assert iters == golden[1] and round(chi2, 2) == golden[0]


def test_own_path_sim3_chain_matches_jax():
    """A graph with 7-wide blocks takes the solver's own path unasked: the
    Sim(3) chain of io/datasets.py with its loop closure moved before the
    last odometry edge (so a new vertex follows it and a solve runs),
    -nsp 1 with -nset 1e-4, against the JAX package's solver on the same
    numpy."""
    vertices, edges = D.make_sim3_chain()
    lists = (vertices, edges[:-2] + [edges[-1], edges[-2]])
    jchi2, jit = JInc(D.fill_system(JSystem(), *lists), every_n=1, dx_threshold=1e-4).run()
    inc = IncrementalSolver(D.fill_system(TSystem(), *lists), device="cpu", every_n=1,
                            dx_threshold=1e-4)
    assert inc._delegate is None and inc._dense
    start = float(inc.asm.chi2(inc.asm.snapshot_states(inc.system)))
    chi2, it = inc.run()
    assert inc.n_solves == 1 and it == jit > 0
    assert abs(chi2 - jchi2) <= 1e-8 * jchi2 and chi2 < 0.05 * start


def test_se3_ternary_replay_is_finite(files):
    """The SE(3) replay with the ternary hyperedge (three-slot activations
    and omega contributions)."""
    system = tparse(files["ternary40"])
    assert "edge_pose3d_ternary" in system.edge_stores
    fl = TFastL(system, device="cpu")
    chi2, iters = fl.run()
    assert np.isfinite(chi2) and iters > 0


@pytest.mark.parametrize("flags, golden", [
    (["-nsp", "1", "-fL"], ("manhattan300_91", "46.20", 8)),
    (["-nsp", "1"], ("manhattan300_1", "1980.14", 30)),
], ids=["fastl", "lambda"])
def test_cli_incremental(files, capsys, flags, golden):
    name, chi2, iters = golden
    assert tmain.main(["-i", files[name], "-po", "--device", "cpu", "-dx", ""] + flags) == 0
    out = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("done. it took ") for ln in out)
    assert f"solver took {iters} iterations" in out
    assert f"denormalized chi2 error: {chi2}" in out


@pytest.mark.parametrize("case", ["no_input", "no_edges"])
def test_cli_errors_match_jax(tmp_path, capsys, case):
    """A missing -i and a file with no edges: the JAX CLI's message, and
    return code 1, before any solver is built."""
    argv = []
    if case == "no_edges":
        p = tmp_path / "empty.g2o"
        p.write_text("# no edges\n")
        argv = ["-i", str(p)]
    assert jmain.main(argv + ["-nb", "-dx", ""]) == 1
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert tmain.main(argv + ["--device", "cpu", "-dx", ""]) == 1
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want == ("error: no input file (-i)" if case == "no_input"
                           else "error: no edges in the dataset")


# ---- FastL's in-loop marginals ----------------------------------------------

@pytest.fixture(scope="module")
def inloop(files):
    """The JAX package's FastL with in-loop marginals (its JAX engine: the
    native one keeps none) and the port's on manhattan 300 seed 92, loop
    0.3, which activates vertices between solve points."""
    path = files["m300_92"]
    jfl = JFastL(jparse(path), every_n=1, config=SolverConfig(marginals=JPolicy(enabled=True)))
    jchi2, jit = jfl.run()
    tfl = TFastL(tparse(path), device="cpu", marginals=True)
    checks = []
    update = tfl._sigma_update

    def checking_update(stores, G, D_):
        update(stores, G, D_)
        fresh = tfl.chol.marginals_from_stores(stores, tfl.inc)[tfl.chol._diag_pos0]
        checks.append((_rel(tfl._sigma_diag, fresh), bool((D_ < 0).any())))

    tfl._sigma_update = checking_update
    chi2, it = tfl.run()
    return jfl, jchi2, jit, tfl, chi2, it, checks


def test_inloop_marginals_follow_jax(inloop):
    """The same trajectory and the same update / recalculate decisions as
    the JAX package, and the last maintained diagonal against its (1e-8:
    kappa ~1e8, measured 1.6e-9)."""
    jfl, jchi2, jit, tfl, chi2, it, _checks = inloop
    assert it == jit and abs(chi2 - jchi2) <= 1e-9 * jchi2
    assert tfl.marginals_trace == jfl.marginals_trace
    assert {"update", "recalculate"} <= set(tfl.marginals_trace)
    got = tfl.sigma_diag()
    assert got.shape == (tfl.asm.Np, tfl.asm.Bp, tfl.asm.Bp)
    assert _rel(got, np.asarray(jfl.sigma_diag())) <= 1e-8


def test_inloop_updates_equal_a_recompute(inloop):
    """Every Woodbury update against a fresh recurrent recovery from the
    same maintained stores, 1e-8; some of them take the -1 columns of
    vertices activated between solve points."""
    *_rest, checks = inloop
    assert len(checks) >= 5 and max(e for e, _down in checks) <= 1e-8, checks
    assert any(down for _e, down in checks)


def test_inloop_update_cuts_over_to_a_recompute(inloop):
    """The Woodbury columns are counted on the host before G is built: 31
    pending SE(2) edges, one of which activates a vertex (93 + 3 = 96
    columns), build G and D; 33 edges (99) are left to a recompute."""
    *_rest, tfl, _chi2, _it, _checks = inloop
    states = tfl.asm.snapshot_states(tfl.system)
    (ename, store), = tfl.system.edge_stores.items()
    none = np.zeros(2, dtype=bool)
    pend = [(ename, li, none) for li in range(33)]
    G, D = tfl._build_G(pend[:30] + [(ename, 30, np.array([False, True]))], states)
    assert G.shape == (tfl.asm.Np * tfl.asm.Bp, 96) and D.tolist() == [1.0] * 93 + [-1.0] * 3
    assert (G[:, 93:].sum(0) == 1).all()
    assert tfl._build_G(pend, states) is None


def test_inloop_updates_on_se3_equal_a_recompute(files):
    """On an SE(3) graph (edge_pose3d is split into expectation and error,
    and robust) every Woodbury update against a fresh recompute from the
    same stores: 1e-7 (measured <= 3e-8 over 40 updates).  The JAX
    package's G columns differentiate the error instead of the expectation
    lambda is built from, and its updates drift 77%-520% from the
    recompute on this file (ROADMAP.md Queue 3)."""
    fl = TFastL(tparse(files["sphere48"]), device="cpu", marginals=True)
    assert len(fl.chol.plan.levels) >= 1
    errs = []
    update = fl._sigma_update

    def checking_update(stores, G, D_):
        update(stores, G, D_)
        fresh = fl.chol.marginals_from_stores(stores, fl.inc)[fl.chol._diag_pos0]
        errs.append(_rel(fl._sigma_diag, fresh))

    fl._sigma_update = checking_update
    fl.run()
    assert len(errs) >= 20 and max(errs) <= 1e-7, errs


@pytest.mark.parametrize("solver", ["lambda", "fastl"])
def test_cli_dump_each_step_matches_jax(tmp_path, capsys, solver):
    """-dsi DIR through both CLIs on a small manhattan with loop closures,
    -nsp 1: the same iterations; the incremental lambda solver takes its own
    path and writes one solution per step, as many as the JAX CLI, each equal to the JAX one to 1e-8
    (both solve float64 by a dense Cholesky; the CLI prints 10 decimals),
    the last equal to the -dx file; with -fL both make the directory and
    dump nothing."""
    poses, edges = D.make_manhattan_2d(n_poses=80, seed=12)   # 7 loop closures
    p = str(tmp_path / "m80.g2o")
    D.write_g2o_2d(p, edges, poses)
    flags = ["-nsp", "1"] + (["-fL"] if solver == "fastl" else [])
    dirs = {k: tmp_path / f"dumps_{k}" for k in ("jax", "port")}
    assert jmain.main(["-i", p, "-s", "-nb", "-dx", str(tmp_path / "jax.txt"),
                       "-dsi", str(dirs["jax"])] + flags) == 0
    want = capsys.readouterr().out.splitlines()
    assert tmain.main(["-i", p, "-s", "--device", "cpu", "-dx", str(tmp_path / "port.txt"),
                       "-dsi", str(dirs["port"])] + flags) == 0
    got = capsys.readouterr().out.splitlines()
    iters = [ln for ln in got if ln.startswith("solver took ")]
    assert iters == [ln for ln in want if ln.startswith("solver took ")]
    assert iters and iters[0] != "solver took 0 iterations"
    names = {k: sorted(x.name for x in d.iterdir()) for k, d in dirs.items()}
    assert names["port"] == names["jax"]
    if solver == "fastl":
        assert names["port"] == []
        return
    assert len(names["port"]) == tparse(p).num_edges
    for name in names["port"]:
        got, want = (np.loadtxt(dirs[k] / name) for k in ("port", "jax"))
        assert np.abs(got - want).max() <= 1e-8 * max(np.abs(want).max(), 1.0), name
    last = np.loadtxt(dirs["port"] / names["port"][-1])
    assert np.array_equal(last, np.loadtxt(tmp_path / "port.txt"))
