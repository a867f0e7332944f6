"""Port parity for the pose-graph linear algebra: the MIS-Schur block
Cholesky (symbolic plan and numeric solve, float64 and the float32 ridge
path), the float32 PCG around it, the lambda spmv, the dense solve and the
planar block helpers, against the JAX package on the CPU.  The solve cases
mirror tests/test_block_cholesky.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.block_cholesky import BlockCholeskySolver as JBC
from slam_plus_plus_tpu.linalg.dense import solve_dense_spd as jsolve_dense
from slam_plus_plus_tpu.linalg.spmv import lambda_spmv as jspmv
from slam_plus_plus_tpu.ops import planar as jplanar
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
from slam_plus_plus_tpu.solvers.lm import damp_system as jdamp
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver as TBC
from slam_plus_plus_tpu_torch.linalg.dense import solve_dense_spd as tsolve_dense
from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv
from slam_plus_plus_tpu_torch.ops import planar as tplanar
from slam_plus_plus_tpu_torch.solvers.gauss_newton import (
    F32_MAX_LEVELS, PCG_ITERATIONS, sparse_solve)
from test_block_cholesky import _block_spd_from_pairs, _grid_pairs, _random_block_spd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's small tensor ops gain nothing from
    more, and under pytest-xdist a pool per worker oversubscribes the cores
    (the float32 manhattan3500 solve takes ~10x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0)


def _system(case):
    """(rows, cols, blocks, N, B, solver kwargs) of tests/test_block_cholesky.py."""
    if case == "grid45":
        rr, cc = _grid_pairs(45)
        return (*_block_spd_from_pairs(rr, cc, 45 * 45, 3, 11), 45 * 45, 3, {})
    N, B, extra, seed = case
    return (*_random_block_spd(N, B, extra, seed), N, B, dict(bottom=max(8, N // 20)))


CASES = [(40, 3, 80, 0), (300, 3, 700, 1), (300, 6, 700, 2), "grid45"]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plan_and_solve_match(case):
    rows, cols, blocks, N, B, kw = _system(case)
    eta = np.random.default_rng(N + B).normal(0, 1, (N, B))
    js = JBC(rows, cols, N, B, **kw)
    ts = TBC(rows, cols, N, B, device="cpu", **kw)
    assert ts.n_levels == js.n_levels >= 1
    for jl, tl in zip(js.plan.levels, ts.plan.levels):
        for field in jl.__dataclass_fields__:
            assert np.array_equal(getattr(jl, field), getattr(tl, field)), field
    for attr in ("input_perm", "rows0", "cols0", "diag_pos0",
                 "_bottom_idx", "_bottom_idx_t", "_bottom_off"):
        assert np.array_equal(getattr(js.plan, attr), getattr(ts.plan, attr)), attr
    assert js.plan.n_bottom == ts.plan.n_bottom
    want = js.solve(jnp.asarray(blocks), jnp.asarray(eta))
    got = ts.solve(torch.from_numpy(blocks), torch.from_numpy(eta))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-10


@pytest.mark.parametrize("case", CASES, ids=str)
def test_f32_blocks_take_the_ridge_path(case):
    """float32 blocks on the CPU reach the float32 branch of both packages
    (per-level relative ridge, the bottom ridge ladder) at the caller's
    depth cap."""
    rows, cols, blocks, N, B, kw = _system(case)
    eta = np.random.default_rng(N + B).normal(0, 1, (N, B))
    kw = dict(kw, max_levels=F32_MAX_LEVELS)
    want = JBC(rows, cols, N, B, **kw).solve(jnp.asarray(blocks, dtype=jnp.float32),
                                            jnp.asarray(eta, dtype=jnp.float32))
    got = TBC(rows, cols, N, B, device="cpu", **kw).solve(
        torch.tensor(blocks, dtype=torch.float32), torch.tensor(eta, dtype=torch.float32))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    assert _rel(got.numpy(), want) <= 1e-4


def test_factor_reuse_multiple_rhs():
    rows, cols, blocks, N, B, _ = _system((200, 3, 400, 7))
    js = JBC(rows, cols, N, B, bottom=16)
    ts = TBC(rows, cols, N, B, device="cpu", bottom=16)
    jf, tf = js.factor(jnp.asarray(blocks)), ts.factor(torch.from_numpy(blocks))
    rng = np.random.default_rng(8)
    for _ in range(3):
        eta = rng.normal(0, 1, (N, B))
        want = js.solve_with_factor(jf, jnp.asarray(eta))
        assert _rel(ts.solve_with_factor(tf, torch.from_numpy(eta)).numpy(), want) <= 1e-10


@pytest.fixture(scope="module")
def manhattan(tmp_path_factory):
    poses, edges = jds.make_manhattan_2d(n_poses=800, seed=21)
    p = str(tmp_path_factory.mktemp("bc") / "m.g2o")
    jds.write_g2o_2d(p, edges, poses)
    return p


def test_manhattan_lambda_solve(tmp_path):
    """The real assembled pose-graph lambda in float64, as the JAX test of
    the same name (manhattan 400, bottom=32: several levels), held to that
    test's tolerance against both the scipy oracle and the JAX solver: this
    lambda's condition puts any two float64 solves ~1e-9 apart, so the
    1e-10 of the random systems above does not apply."""
    import scipy.sparse.linalg as spla
    from slam_plus_plus_tpu.linalg.bsr import partitioned_to_scipy

    poses, edges = jds.make_manhattan_2d(n_poses=400, seed=21)
    p = str(tmp_path / "m.txt")
    jds.write_g2o_2d(p, edges, poses)
    ta = TAssembler(tparse(p), device="cpu")
    bs = ta.assemble(ta.snapshot_states(tparse(p)))
    ts = TBC(ta.pp_rows, ta.pp_cols, ta.Np, ta.Bp, device="cpu", bottom=32)
    assert ts.n_levels >= 3
    got = ts.solve(bs.pp_blocks, bs.eta_p).numpy()
    blocks, eta = bs.pp_blocks.numpy(), bs.eta_p.numpy()
    A = partitioned_to_scipy(ta.pp_rows, ta.pp_cols, blocks, ta.Np, ta.Bp)
    ref = spla.spsolve(A.tocsc(), eta.ravel()).reshape(ta.Np, ta.Bp)
    assert _rel(got, ref) <= 1e-8
    js = JBC(ta.pp_rows, ta.pp_cols, ta.Np, ta.Bp, bottom=32)
    assert _rel(got, js.solve(jnp.asarray(blocks), jnp.asarray(eta))) <= 1e-8


def _scaled_bottom(factor):
    """factor() with its bottom Cholesky factor scaled by 1.3."""
    def scaled(blocks):
        f = factor(blocks)
        return f._replace(L_bottom=f.L_bottom * 1.3)
    return scaled


def test_f32_pcg_solve_matches(manhattan):
    """The float32 sparse solve of GaussNewtonSolver (depth cap, PCG with
    its fixed trip count and early-exit mask, the solve-quality gate) on the
    same float32 lambda as JAX's jitted one.  The lambda is LM-damped
    (1e-3 x max_hdiag), which bounds its condition so that two float32
    solves can agree to 1e-4; both factors' bottom is scaled by 1.3, which
    leaves the direct solve short of the 1e-4 residual, so the PCG iterates
    in both."""
    js = jparse(manhattan)
    jgn = JGN(js, SolverConfig(dtype=jnp.float32))
    assert jgn._sparse_chol is not None and jgn._sparse_chol.n_levels <= F32_MAX_LEVELS
    base = jgn.asm.assemble(jgn.asm.snapshot_states(js))
    jb = jdamp(base, jnp.float32(1e-3 * float(base.max_hdiag)), jgn.asm.pp_diag_ids_dev)
    jgn._sparse_chol._factor_impl = _scaled_bottom(jgn._sparse_chol._factor_impl)
    want = np.asarray(jgn._sparse_solve_jit(jb))

    ta = TAssembler(tparse(manhattan), device="cpu")
    chol = TBC(ta.pp_rows, ta.pp_cols, ta.Np, ta.Bp, device="cpu", max_levels=F32_MAX_LEVELS)
    assert chol.n_levels == jgn._sparse_chol.n_levels
    chol.factor = _scaled_bottom(chol.factor)
    bs = BlockSystem(*[torch.tensor(np.asarray(x)) for x in jb])
    assert bs.pp_blocks.dtype == torch.float32
    got, taken = sparse_solve(chol, LambdaSpmv(ta), bs, PCG_ITERATIONS)
    assert 1 <= int(taken) < PCG_ITERATIONS
    assert np.isfinite(want).all()
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.fixture(scope="module")
def landmark_pair(tmp_path_factory):
    _gp, _gl, pe, le = jds.make_landmark_2d(n_poses=100, n_landmarks=50, world=12.0,
                                            obs_radius=4.0, seed=3)
    p = str(tmp_path_factory.mktemp("bc") / "l.g2o")
    jds.write_g2o_landmark_2d(p, pe, le)
    js, ts = jparse(p), tparse(p)
    ja = JAssembler(js, SolverConfig(schur_split="on", edge_layout="flat"))
    ta = TAssembler(ts, device="cpu", settings=SolverSettings(schur_split="on"))
    jb = ja.assemble(ja.snapshot_states(js))
    tb = BlockSystem(*[torch.tensor(np.asarray(x)) for x in jb])
    return ja, ta, jb, tb


def test_lambda_spmv_matches(landmark_pair):
    ja, ta, jb, tb = landmark_pair
    assert ta.Nl > 0 and ta.Kpl > 0
    rng = np.random.default_rng(4)
    vp, vl = rng.normal(0, 1, (ta.Np, ta.Bp)), rng.normal(0, 1, (ta.Nl, ta.Bl))
    want = jspmv(ja, jb, jnp.asarray(vp), jnp.asarray(vl))
    got = LambdaSpmv(ta)(tb, torch.from_numpy(vp), torch.from_numpy(vl))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-12


def test_dense_solve_matches(landmark_pair):
    ja, ta, jb, tb = landmark_pair
    want = jsolve_dense(ja.pp_rows, ja.pp_cols, jb.pp_blocks, jb.eta_p, ja.Np, ja.Bp)
    got = tsolve_dense(ta.pp_rows, ta.pp_cols, tb.pp_blocks, tb.eta_p, ta.Np, ta.Bp)
    assert _rel(got.numpy(), want) <= 1e-10


PLANAR = {
    "bmm_At_B": lambda m, a, b, B: m.bmm_At_B(a, b, B, B, B),
    "bmm_A_Bt": lambda m, a, b, B: m.bmm_A_Bt(a, b, B, B, B),
    "bmv_At": lambda m, a, b, B: m.bmv_At(a, b[:, :B], B, B),
    "btranspose": lambda m, a, b, B: m.btranspose(a, B, B),
    "bdiag": lambda m, a, b, B: m.bdiag(a, B),
    "badd_diag": lambda m, a, b, B: m.badd_diag(a, b[:, 0], B),
    "binv": lambda m, a, b, B: m.binv(a, B),
}


@pytest.mark.parametrize("B", [3, 6])
@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_op_matches(name, B):
    fn = PLANAR[name]
    rng = np.random.default_rng(B)
    a = rng.normal(0, 1, (64, B, B))
    a = (a @ a.transpose(0, 2, 1) + B * np.eye(B)).reshape(64, B * B)  # SPD for binv
    b = rng.normal(0, 1, (64, B * B))
    want = np.asarray(fn(jplanar, jnp.asarray(a), jnp.asarray(b), B))
    got = fn(tplanar, torch.from_numpy(a), torch.from_numpy(b), B)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
