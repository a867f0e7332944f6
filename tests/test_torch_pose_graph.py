"""Port parity for pose-graph SLAM as a whole: the generic per-edge Jacobian
assembly (host plan and block system), batch Gauss-Newton on its dense,
block-Cholesky and flat-layout Schur branches, Lambda-LM without a landmark
class, and the CLI, on both packages on the CPU: float64, and float32 where
a test says so."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app import main as jmain
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.schur import SchurSolver as JSchur
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg import schur as tschur
from slam_plus_plus_tpu_torch.linalg.dense import solve_dense_spd
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver as TGN
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver as TLM

_INFO6 = " ".join(["20 0 0 0 0 0 20 0 0 0 0 20 0 0 0 20 0 0 20 0 20"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's small tensor ops gain nothing from
    more, and under pytest-xdist a pool per worker oversubscribes the cores
    (the float32 manhattan3500 solve takes ~10x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pose_graph")
    out = {}

    def path(name):
        out[name] = str(d / f"{name}.g2o")
        return out[name]

    poses, edges = jds.make_manhattan_2d(n_poses=200, seed=3, loop_prob=0.3)
    jds.write_g2o_2d(path("manhattan200"), edges, poses)
    poses, edges = jds.make_manhattan_2d(n_poses=400, seed=21)
    jds.write_g2o_2d(path("manhattan400"), edges, poses)
    poses, edges = jds.make_city_2d(n_poses=2600, seed=13)
    jds.write_g2o_2d(path("city2600"), edges, poses)
    poses, edges = jds.make_sphere_3d(n_poses=100, seed=4)
    jds.write_g2o_3d(path("sphere100"), edges, poses)
    poses, edges = jds.make_sphere_3d(n_poses=60, seed=8, trans_noise=0.01, rot_noise=0.005)
    jds.write_g2o_3d(path("sphere60"), edges, poses)
    # ternary hyperedges over a sphere walk, some with their slots in
    # descending vertex order (swapped pp pairs)
    poses, edges = jds.make_sphere_3d(n_poses=40, seed=11)
    jds.write_g2o_3d(path("ternary"), edges, poses)
    n = len(jparse(out["ternary"]).vertex_order)
    with open(out["ternary"], "a") as f:
        for i in range(0, n - 2, 3):
            ids = (i, i + 1, i + 2) if i % 2 else (i + 2, i + 1, i)
            f.write(f"EDGE3:TERNARY {ids[0]} {ids[1]} {ids[2]} 0.01 0 0 0 0.002 0 "
                    f"{_INFO6}\n")
    _gp, _gl, pe, le = jds.make_landmark_2d(n_poses=120, n_landmarks=60, world=15.0,
                                            obs_radius=4.0, seed=5)
    jds.write_g2o_landmark_2d(path("landmark"), pe, le)
    return out


#: (file, JAX SolverConfig kwargs, port SolverSettings kwargs).  With the
#: split on, the JAX package is held to its flat edge layout, which the
#: port's generic path implements.
ASSEMBLY_CASES = {
    "manhattan": ("manhattan200", {}, {}),
    "sphere": ("sphere100", {}, {}),
    "ternary": ("ternary", {}, {}),
    "landmark_split_on": ("landmark", dict(schur_split="on", edge_layout="flat"),
                          dict(schur_split="on")),
    "landmark_split_off": ("landmark", dict(schur_split="off"), dict(schur_split="off")),
}


@pytest.mark.parametrize("case", sorted(ASSEMBLY_CASES))
def test_host_plan_and_assembly_match(files, case):
    name, jcfg, tcfg = ASSEMBLY_CASES[case]
    js, ts = jparse(files[name]), tparse(files[name])
    ja = JAssembler(js, SolverConfig(**jcfg))
    ta = TAssembler(ts, device="cpu", settings=SolverSettings(**tcfg))
    assert ja.pl_uniform is None and ta.pl_uniform is None
    for attr in ("pp_rows", "pp_cols", "pl_rows", "pl_cols", "pp_diag_ids",
                 "p_mask", "l_mask"):
        assert np.array_equal(getattr(ja, attr), getattr(ta, attr)), attr
    assert (ja.Np, ja.Nl, ja.Bp, ja.Bl, ja.Kpp, ja.Kpl, ja.anchor_cslot) == \
        (ta.Np, ta.Nl, ta.Bp, ta.Bl, ta.Kpp, ta.Kpl, ta.anchor_cslot)
    assert ja.type_class == ta.type_class
    for t in ja.type_cslot:
        assert np.array_equal(ja.type_cslot[t], ta.type_cslot[t]), t
    if case == "landmark_split_off":
        assert ta.Nl == 0 and ta.Bp == 3 and not ta.p_mask.all()  # padded dims
    if case == "landmark_split_on":
        assert ta.Nl > 0 and ta.Kpl > 0
    if case == "ternary":
        (plan,) = [p for p in ta.plans if p.name == "edge_pose3d_ternary"]
        assert any(w.any() for (_a, _b, _s, w) in plan.pp_contribs)

    jst = ja.snapshot_states(js)
    tst = ta.states_from_numpy({k: np.asarray(v) for k, v in jst.items()})
    jb, tb = ja.assemble(jst), ta.assemble(tst)
    for field in jb._fields:
        w = np.asarray(getattr(jb, field))
        g = getattr(tb, field)
        assert g.dtype == torch.float64 and g.shape == w.shape, field
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(g.numpy() - w).max() <= 1e-9 * scale, field
    jchi2 = float(ja.chi2(jst))
    assert abs(float(ta.chi2(tst)) - jchi2) <= 1e-9 * jchi2

    rng = np.random.default_rng(2)
    dx_p = rng.normal(0, 0.05, (max(ja.Np, 1), ja.Bp)) * ja.p_mask
    dx_l = rng.normal(0, 0.05, (max(ja.Nl, 1), ja.Bl)) * ja.l_mask
    want = ja.update(jst, jnp.asarray(dx_p), jnp.asarray(dx_l))
    got = ta.update(tst, torch.from_numpy(dx_p), torch.from_numpy(dx_l))
    for t in want:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=0, atol=1e-12)


def _jax_gn_log(path, config=None):
    """The JAX GN run: (final chi2, iterations, chi2 at each linearization)."""
    gn = JGN(jparse(path), config)
    log, assemble = [], gn.asm.assemble

    def spy(states):
        bs = assemble(states)
        log.append(float(bs.chi2))
        return bs

    gn.asm.assemble = spy
    chi2, iters = gn.optimize(5)
    return chi2, iters, log


def test_gn_dense_branch_matches(files):
    jchi2, jit, jlog = _jax_gn_log(files["manhattan400"])
    gn = TGN(tparse(files["manhattan400"]), device="cpu")
    assert gn._dense is not None and gn._sparse_chol is None
    chi2, iters = gn.optimize(5)
    assert iters == jit == len(gn.iteration_log)
    for (c, _dx), jc in zip(gn.iteration_log, jlog):
        assert abs(c - jc) <= 1e-8 * jc
    assert abs(chi2 - jchi2) <= 1e-8 * jchi2


def test_gn_forced_block_cholesky_matches(files):
    """linear_solver="block_cholesky" takes the block Cholesky where "auto"
    takes the dense factor, as the JAX SolverConfig field of that value."""
    path = files["manhattan200"]
    jchi2, jit, jlog = _jax_gn_log(path, SolverConfig(linear_solver="block_cholesky"))
    gn = TGN(tparse(path), device="cpu",
             settings=SolverSettings(linear_solver="block_cholesky"))
    assert gn._dense is None and gn._sparse_chol is not None
    chi2, iters = gn.optimize(5)
    assert iters == jit == len(gn.iteration_log)
    for (c, _dx), jc in zip(gn.iteration_log, jlog):
        assert abs(c - jc) <= 1e-8 * jc
    assert abs(chi2 - jchi2) <= 1e-8 * jchi2
    with pytest.raises(ValueError, match="one of auto, block_cholesky, scipy"):
        SolverSettings(linear_solver="cholmod")


def test_gn_block_cholesky_branch_matches(files):
    """city2600 (7800 dims, beyond the dense limit) through the MIS-Schur
    block Cholesky, as tests/test_block_cholesky.py::test_gn_city_uses_sparse_chol.
    The same iteration count and final chi2 to 1e-8.  Per iteration, each
    chi2 within 1e-8 of the JAX block-Cholesky run's, or, where the step's
    conditioning makes the JAX package's own two float64 backends (block
    Cholesky and its scipy oracle) disagree by more, no farther from the
    JAX block-Cholesky run than the oracle is."""
    path = files["city2600"]
    jchi2, jit, jlog = _jax_gn_log(path)
    _ochi2, oit, olog = _jax_gn_log(path, SolverConfig(linear_solver="scipy"))
    gn = TGN(tparse(path), device="cpu")
    assert gn._sparse_chol is not None and gn._sparse_chol.n_levels >= 1
    assert gn.pcg_iterations == 0          # float64: the direct solve only
    chi2, iters = gn.optimize(5)
    assert iters == jit == oit == len(gn.iteration_log)
    for k, ((c, _dx), jc, oc) in enumerate(zip(gn.iteration_log, jlog, olog)):
        gap = abs(oc - jc)
        if gap <= 1e-8 * jc:
            assert abs(c - jc) <= 1e-8 * jc
        else:
            print(f"iteration {k}: the JAX package's block Cholesky and scipy oracle "
                  f"differ by {gap / jc:.2e} relative; the port is held to that gap")
            assert abs(c - jc) <= gap
    assert abs(chi2 - jchi2) <= 1e-8 * jchi2


@pytest.mark.parametrize("solver", ["gn", "lm"])
def test_f32_solvers_follow_the_jax_package(files, solver):
    """float32 GN and LM on the block Cholesky with its PCG (the card's
    configuration, reached on the CPU by ``dtype=torch.float32``) against
    the JAX package's float32 run: the same iteration count and final chi2
    to 1e-4 relative, and for LM every trial's chi2 to 1e-4."""
    path = files["manhattan200"]
    jcls, tcls = (JGN, TGN) if solver == "gn" else (JLM, TLM)
    jrun = jcls(jparse(path), SolverConfig(dtype=jnp.float32, linear_solver="block_cholesky"))
    jlog, assemble = [], jrun.asm.assemble

    def spy(states):
        bs = assemble(states)
        jlog.append(float(bs.chi2))
        return bs

    jrun.asm.assemble = spy
    jchi2, jit = jrun.optimize(5)
    trun = tcls(tparse(path), device="cpu",
                settings=SolverSettings(linear_solver="block_cholesky"), dtype=torch.float32)
    assert trun.asm.dtype == torch.float32 and trun.pcg_iterations > 0
    chi2, iters = trun.optimize(5)
    assert iters == jit and abs(chi2 - jchi2) <= 1e-4 * jchi2
    assert sum(int(t) for t in trun.pcg_taken) > 0
    if solver == "lm":
        assert len(trun.trial_log) == len(jlog) - 1
        for (_dx, err, _den), je in zip(trun.trial_log, jlog[1:]):
            assert abs(err - je) <= 1e-4 * je


@pytest.mark.parametrize("chunk", [None, 4], ids=["one_chunk", "chunks_of_4_landmarks"])
def test_flat_schur_solve_matches(files, monkeypatch, chunk):
    """The Schur solve of the flat edge layout (landmark SLAM, class split
    off) against the JAX package's on the same float64 block system.  With
    chunks of 4 landmarks the port sums the Schur complement over several
    panel chunks, as the JAX package does for panels past 512 MB."""
    js, ts = jparse(files["landmark"]), tparse(files["landmark"])
    ja = JAssembler(js, SolverConfig(schur_split="on", edge_layout="flat"))
    ta = TAssembler(ts, device="cpu", settings=SolverSettings(schur_split="on"))
    jb = ja.assemble(ja.snapshot_states(js))
    tb = BlockSystem(*[torch.tensor(np.asarray(x)) for x in jb])
    if chunk:
        monkeypatch.setattr(tschur, "_pick_chunk", lambda *_a: chunk)
    solver = tschur.SchurSolver(ta)
    n_chunks = 1 if chunk is None else -(-ta.Nl // chunk)
    assert not solver.uniform and len(solver._starts) == n_chunks + 1
    assert n_chunks == 1 or n_chunks >= 3
    for w, g in zip(JSchur(ja).solve(jb), solver.solve(tb)):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-9 * max(np.abs(w).max(), 1.0)


def test_gn_landmark_graph_takes_the_flat_schur(files):
    """A landmark graph whose pose dims stay under the auto split's 20,000:
    both packages split the landmark class off and solve by Schur (the JAX
    package in its uniform layout, the port in the flat one, the same
    system): the same iteration count, chi2 per iteration to 1e-8."""
    path = files["landmark"]
    jchi2, jit, jlog = _jax_gn_log(path)
    gn = TGN(tparse(path), device="cpu")
    assert gn._schur is not None and not gn._schur.uniform and gn.asm.Nl > 0
    chi2, iters = gn.optimize(5)
    assert iters == jit == len(gn.iteration_log)
    for (c, _dx), jc in zip(gn.iteration_log, jlog):
        assert abs(c - jc) <= 1e-8 * jc
    assert abs(chi2 - jchi2) <= 1e-8 * jchi2


def test_lm_without_landmarks_matches(files):
    """Lambda-LM over the dense branch (no landmark class: damp_system's ll
    is the [1, 1] placeholder): the same |dx| and trial chi2 per trial."""
    path = files["sphere60"]
    jlm = JLM(jparse(path))
    dxs, chis = [], []
    solve, assemble = jlm._solve, jlm.asm.assemble

    def spy_solve(bs):
        dx_p, dx_l = solve(bs)
        dxs.append(float(jnp.sqrt(jnp.sum(dx_p * dx_p) + jnp.sum(dx_l * dx_l))))
        return dx_p, dx_l

    def spy_assemble(states):
        bs = assemble(states)
        chis.append(float(bs.chi2))
        return bs

    jlm._solve, jlm.asm.assemble = spy_solve, spy_assemble
    jchi2, jit = jlm.optimize(5)
    tlm = TLM(tparse(path), device="cpu")
    assert tlm._schur is None and tlm._dense is not None
    tchi2, tit = tlm.optimize(5)
    assert tit == jit == len(tlm.trial_log) == len(dxs)
    for (tn, te, _), jn, je in zip(tlm.trial_log, dxs, chis[1:]):
        assert abs(tn - jn) <= 1e-8 * max(jn, 1.0)
        assert abs(te - je) <= 1e-8 * je
    assert abs(tchi2 - jchi2) <= 1e-8 * jchi2


@pytest.mark.parametrize("name, flags", [("manhattan200", ["-po"]), ("sphere60", ["-lm"]),
                                         ("landmark", [])])
def test_cli_prints_the_same_chi2(files, capsys, name, flags):
    assert jmain.main(["-i", files[name], "-nb", "-dx", ""] + flags) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(("denormalized chi2 error:", "solver took"))]
    assert len(want) == 2
    assert tmain.main(["-i", files[name], "--device", "cpu", "-dx", ""] + flags) == 0
    out = capsys.readouterr().out.splitlines()
    for line in want:
        assert line in out


def test_route_dtype_on_the_card(files, tmp_path):
    """The dtype GN / LM take on --device cuda, decided from the vertex
    classes before any assembler (no card needed): float64 on the
    pose-graph route (SE(2) / SE(3) graphs, a landmark graph or a ROCV
    scene kept in one class, as past 20000 pose dims, every system under
    "scipy"), float32 on the Schur route (BA, Sim(3) BA, a landmark graph
    or a small ROCV scene split off); the CPU is float64 either way."""
    from slam_plus_plus_tpu_torch.graph.system import GraphSystem as TSystem
    from slam_plus_plus_tpu_torch.io import datasets as tds
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import route_dtype

    ba = str(tmp_path / "ba.g2o")
    tds.write_g2o_ba(ba, *tds.make_ba_scene(n_cams=5, n_points=40, seed=2))
    rocv = str(tmp_path / "rocv.g2o")
    tds.write_g2o_rocv(rocv, *tds.make_rocv_scene(n_steps=20, seed=33))
    default, off, scipy = (SolverSettings(), SolverSettings(schur_split="off"),
                           SolverSettings(linear_solver="scipy"))
    cases = [(tparse(files["manhattan200"]), default, torch.float64),
             (tparse(files["sphere60"]), default, torch.float64),
             (tparse(files["landmark"]), default, torch.float32),
             (tparse(files["landmark"]), off, torch.float64),
             (tparse(ba), default, torch.float32),
             (tparse(ba), scipy, torch.float64),
             (tparse(rocv), default, torch.float32),
             (tparse(rocv), off, torch.float64),
             (tds.fill_system(TSystem(), *tds.make_sim3_chain()), default, torch.float64),
             (tds.fill_system(TSystem(), *tds.make_sim3_invdist_ba()), default, torch.float32)]
    for system, settings, want in cases:
        assert route_dtype(system, "cuda", settings) == want
        assert route_dtype(system, "cpu", settings) == torch.float64
    gn = TGN(tparse(files["manhattan200"]), device="cpu", dtype=torch.float32)
    assert gn.asm.dtype == torch.float32 and gn.pcg_iterations > 0


def test_manhattan3500_is_gated_as_every_row():
    """The card's pose GN runs float64 since the float32 miss (ROADMAP
    Queue 3, F1): no row keeps the float32 exemption."""
    from slam_plus_plus_tpu_torch.io import acceptance

    assert "manhattan3500" not in acceptance.FLOAT32_MISSES
    assert not acceptance.FLOAT32_MISSES
