"""Port parity for the rest of batch solving, float64 on the CPU: the host
scipy oracle (``partitioned_to_scipy``, ``HostSparseSolver``) and GN's
branch selection ("scipy", "auto" and "block_cholesky"), the A solver (its
rectangular A and its trajectory), the SPCG solver (the spanning tree and
the step under both preconditioners), and the CLI's -A, -dx and -gt, each
against the JAX package on the same seeded input.

Tolerances: 1e-10 x scale for float64 arithmetic done the same way in both
packages; 1e-8 x scale where a step passes through scipy's splu or LSQR or
through 200 CG trips."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app import main as jmain
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.bsr import partitioned_to_scipy as jbsr
from slam_plus_plus_tpu.solvers.a_solver import ASolver as JA
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
from slam_plus_plus_tpu.solvers.spcg import SPCGSolver as JSPCG
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.bsr import partitioned_to_scipy as tbsr
from slam_plus_plus_tpu_torch.solvers.a_solver import ASolver as TA
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver as TGN
from slam_plus_plus_tpu_torch.solvers.spcg import SPCGSolver as TSPCG

F64_TOL = 1e-10      # the same float64 arithmetic in both packages
HOST_TOL = 1e-8      # through scipy's splu / LSQR, or 200 CG trips


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: small tensor ops gain nothing from more, and
    under pytest-xdist a pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch_solvers")
    out = {}

    def path(name):
        out[name] = str(d / f"{name}.g2o")
        return out[name]

    poses, edges = jds.make_manhattan_2d(n_poses=50, seed=3, loop_prob=0.3)
    jds.write_g2o_2d(path("manhattan50"), edges, poses)
    poses, edges = jds.make_manhattan_2d(n_poses=2010, seed=12, loop_prob=0.05)
    jds.write_g2o_2d(path("manhattan2010"), edges, poses)
    poses, edges = jds.make_sphere_3d(n_poses=30, seed=8, trans_noise=0.01, rot_noise=0.005)
    jds.write_g2o_3d(path("sphere30"), edges, poses)
    _gp, _gl, pe, le = jds.make_landmark_2d(n_poses=30, n_landmarks=20, world=8.0,
                                            obs_radius=4.0, seed=5)
    jds.write_g2o_landmark_2d(path("landmark"), pe, le)
    return out


def _rel(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _same_block_system(jsolver):
    """The JAX solver's block system at its initial states, and the port's
    copy of it."""
    jb = jsolver.asm.assemble(jsolver.asm.snapshot_states(jsolver.system))
    return jb, BlockSystem(*[torch.tensor(np.asarray(x)) for x in jb])


def test_partitioned_to_scipy_matches(files):
    js = jparse(files["landmark"])
    jgn = JGN(js, SolverConfig(schur_split="on", edge_layout="flat"))
    a = jgn.asm
    jb, _ = _same_block_system(jgn)
    args = (a.pp_rows, a.pp_cols, np.asarray(jb.pp_blocks), a.Np, a.Bp, a.pl_rows,
            a.pl_cols, np.asarray(jb.pl_blocks), np.asarray(jb.ll_blocks), a.Nl, a.Bl)
    want, got = jbsr(*args), tbsr(*args)
    assert a.Nl > 0 and got.shape == want.shape
    assert (got != want).nnz == 0


#: (linear_solver, file, the branch GN takes): the host oracle with and
#: without a landmark class; "auto"'s Schur and float64 dense factor; the
#: block Cholesky taken in place of the dense factor
BRANCHES = [("scipy", "landmark", "scipy"), ("scipy", "manhattan50", "scipy"),
            ("scipy", "sphere30", "scipy"), ("auto", "landmark", "schur"),
            ("auto", "manhattan50", "dense"), ("block_cholesky", "manhattan50", "block_cholesky")]


def _branch(gn):
    return ("schur" if gn._schur is not None else "dense" if gn._dense is not None
            else "scipy" if gn._host is not None else "block_cholesky")


def test_auto_takes_block_cholesky_past_the_dense_limit(files):
    """6030 dims: "auto" leaves the dense factor for the block Cholesky (the
    JAX package's rule)."""
    assert _branch(TGN(tparse(files["manhattan2010"]), device="cpu")) == "block_cholesky"


@pytest.mark.parametrize("linear_solver", ["dense", "schur"])
def test_settings_reject_unported_backends(linear_solver):
    """The JAX package's forcing values "dense" and "schur" have no caller in
    the port: "auto" takes both branches where they apply."""
    with pytest.raises(ValueError, match="linear_solver"):
        SolverSettings(linear_solver=linear_solver)


@pytest.mark.parametrize("linear_solver, name, branch", BRANCHES)
def test_gn_branch_step_matches(files, linear_solver, name, branch):
    """The branch's step on the JAX package's block system."""
    jcfg = dict(linear_solver=linear_solver, schur_split="on", edge_layout="flat")
    jgn = JGN(jparse(files[name]), SolverConfig(**jcfg))
    tgn = TGN(tparse(files[name]), device="cpu",
              settings=SolverSettings(linear_solver=linear_solver, schur_split="on"))
    assert _branch(tgn) == branch
    jb, tb = _same_block_system(jgn)
    tol = HOST_TOL if linear_solver == "scipy" else F64_TOL
    for w, g in zip(jgn._solve(jb), tgn._solve(tb)):
        assert g.dtype == torch.float64 and g.shape == np.asarray(w).shape
        assert _rel(g, w) <= tol


def test_gn_scipy_trajectory_matches(files):
    path = files["landmark"]
    jchi2, jit = JGN(jparse(path), SolverConfig(linear_solver="scipy")).optimize(5)
    tgn = TGN(tparse(path), device="cpu", settings=SolverSettings(linear_solver="scipy"))
    chi2, iters = tgn.optimize(5)
    assert iters == jit and abs(chi2 - jchi2) <= HOST_TOL * jchi2


@pytest.mark.parametrize("name", ["manhattan50", "sphere30", "landmark"])
def test_a_solver_matches(files, name):
    """materialize_A at the initial states: the same shape, sparsity and
    values; then the same trajectory (|dx| per iteration, iterations, final
    chi2)."""
    ja, ta = JA(jparse(files[name])), TA(tparse(files[name]), device="cpu")
    assert ta.asm.pl_uniform is None
    (jA, jbv), (tA, tbv) = ja.materialize_A(), ta.materialize_A()
    assert tA.shape == jA.shape
    assert np.array_equal(tA.indptr, jA.indptr) and np.array_equal(tA.indices, jA.indices)
    assert _rel(tA.data, jA.data) <= F64_TOL and _rel(tbv, jbv) <= F64_TOL

    jlog, solve = [], ja._solve_via_A

    def spy(states):
        dx_p, dx_l = solve(states)
        jlog.append(float(jnp.sqrt(jnp.sum(dx_p * dx_p) + jnp.sum(dx_l * dx_l))))
        return dx_p, dx_l

    ja._solve_via_A = spy
    jchi2, jit = ja.optimize(5)
    chi2, iters = ta.optimize(5)
    assert iters == jit == len(ta.iteration_log)
    for g, w in zip(ta.iteration_log, jlog):
        assert abs(g - w) <= HOST_TOL * max(w, 1.0)
    assert abs(chi2 - jchi2) <= HOST_TOL * jchi2


@pytest.mark.parametrize("name, precond", [("manhattan50", "subgraph"), ("sphere30", "subgraph"),
                                           ("landmark", "jacobi")])
def test_spcg_matches(files, name, precond):
    """"auto" picks the preconditioner as the JAX package does; the spanning
    tree keeps the same pairs; the CG step on the same block system."""
    jcfg = dict(schur_split="on", edge_layout="flat")
    jsp = JSPCG(jparse(files[name]), SolverConfig(**jcfg))
    tsp = TSPCG(tparse(files[name]), device="cpu", settings=SolverSettings(schur_split="on"))
    assert jsp.preconditioner == tsp.preconditioner == precond
    if precond == "subgraph":
        assert np.array_equal(tsp._tree_sel.numpy(), np.asarray(jsp._tree_sel))
        assert len(tsp.tree_pairs) == tsp.asm.Np - 1        # a spanning tree
    jb, tb = _same_block_system(jsp)
    for w, g in zip(jsp._solve(jb), tsp._solve(tb)):
        assert _rel(g, w) <= HOST_TOL


def test_spcg_gn_trajectory_matches(files):
    path = files["manhattan50"]
    jchi2, jit = JSPCG(jparse(path)).optimize(5)
    chi2, iters = TSPCG(tparse(path), device="cpu").optimize(5)
    assert iters == jit and abs(chi2 - jchi2) <= HOST_TOL * jchi2


def _cli_lines(out, prefixes):
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


@pytest.mark.parametrize("name", ["manhattan50", "sphere30"])
def test_cli_a_dx_and_gt_match(files, capsys, tmp_path, name):
    """-A through both CLIs: the same chi2 and iteration lines and the same
    -gt ATE/RPE lines (the file's own VERTEX lines are the ground truth);
    the -dx files hold the same states to 1e-8 x scale (the anchored
    vertex moves by LSQR round-off, so its sign of zero differs).  With a
    threshold that stops before the first push the states are the parsed
    ones and the two -dx files are byte-equal."""
    path = files[name]
    keys = ("denormalized chi2", "solver took", "ATE", "RPE", "solution written")
    runs = {}
    for tag, extra in (("solved", ["-gt", path, "--rpe-delta", "2"]),
                       ("unmoved", ["-fnset", "1e9"])):
        jdx, tdx = str(tmp_path / f"j_{tag}.txt"), str(tmp_path / f"t_{tag}.txt")
        assert jmain.main(["-i", path, "-A", "-nb", "-dx", jdx] + extra) == 0
        want = _cli_lines(capsys.readouterr().out, keys)
        assert tmain.main(["-i", path, "-A", "--device", "cpu", "-nb", "-us",
                           "-dx", tdx] + extra) == 0
        got = _cli_lines(capsys.readouterr().out, keys)
        assert len(want) == (5 if tag == "solved" else 3)
        assert got[:-1] == want[:-1] and got[-1] == f"solution written to {tdx}"
        runs[tag] = jdx, tdx
    jdx, tdx = runs["solved"]
    assert _rel(np.loadtxt(tdx), np.loadtxt(jdx)) <= HOST_TOL
    jdx, tdx = runs["unmoved"]
    with open(jdx, "rb") as fj, open(tdx, "rb") as ft:
        assert fj.read() == ft.read()
