"""The JAX package's public members that the port had left out, each against
its JAX counterpart on the same input, float64 on the CPU:
``SolverSettings.robust_overrides`` (tests/test_robust.py's three cases),
``damping_init`` and ``optimize_lm``, ``Marginals.sigma_blocks``,
``IncrementalMarginals.omega_sqrt_for_edge``, ``view_direction_transform``
and the association app's ``gate=`` / ``transform=``, six ``GraphSystem``
methods, and ``so3.rotmat_to_quat`` / ``rotmat_to_axis_angle``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.evaluation import distances as jdist
from slam_plus_plus_tpu.evaluation.error_eval import ate_rmse as jate
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.manifolds import so3 as jso3
from slam_plus_plus_tpu.marginals import Marginals as JMarginals
from slam_plus_plus_tpu.marginals.covariance import IncrementalMarginals as JIncMarg
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
from slam_plus_plus_tpu.solvers.lm import optimize_lm as joptimize_lm
from slam_plus_plus_tpu_torch.app import dataassoc_example
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.evaluation import distances as tdist
from slam_plus_plus_tpu_torch.evaluation.error_eval import ate_rmse as tate
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.manifolds import so3 as tso3
from slam_plus_plus_tpu_torch.marginals import IncrementalMarginals, Marginals
from slam_plus_plus_tpu_torch.robust.losses import LOSSES
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver as TGN
from slam_plus_plus_tpu_torch.solvers.lm import optimize_lm as toptimize_lm


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


# ---- robust_overrides: tests/test_robust.py's cases on both packages ----------

@pytest.fixture(scope="module")
def corrupted_sphere(tmp_path_factory):
    """tests/test_robust.py's graph: a 150-pose sphere (a robust edge type)
    with gross outlier closures, and its true poses."""
    poses, edges = jds.make_sphere_3d(n_poses=150, seed=55)
    rng = np.random.default_rng(56)
    closures = [k for k, e in enumerate(edges) if abs(e[0] - e[1]) > 1]
    for k in rng.choice(closures, size=min(12, len(closures)), replace=False):
        i, j, z, info = edges[k]
        z = np.array(z, copy=True)
        z[:3] += rng.normal(0, 4.0, 3)
        edges[k] = (i, j, z, info)
    p = str(tmp_path_factory.mktemp("robust") / "sph.txt")
    jds.write_g2o_3d(p, edges, poses)
    return p, np.asarray(poses)


def _robust_run(path, gt, overrides, iters, threshold=0.01):
    """Both packages' GN from the true poses (the IRLS regime) under the
    overrides: ((JAX chi2, ATE), (port chi2, ATE))."""
    out = []
    for parse, run in (
            (jparse, lambda s: JGN(s, SolverConfig(robust_overrides=overrides))),
            (tparse, lambda s: TGN(s, device="cpu",
                                   settings=SolverSettings(robust_overrides=overrides)))):
        s = parse(path)
        store = s.vertex_stores["pose3d"]
        store.states[:len(gt)] = gt
        chi2, _ = run(s).optimize(iters, threshold)
        est = np.stack([store.states[i][:3] for i in range(len(gt))])
        out.append((chi2, (jate if parse is jparse else tate)(est, gt[:, :3])))
    return out


def _robust_losses_beat_plain(path, gt):
    ates = {}
    for loss in ("none", "huber", "cauchy", "tukey"):
        (jchi2, jate_), (tchi2, tate_) = _robust_run(path, gt, {"*": (loss, 0.3)}, 10, 0.001)
        assert abs(tchi2 - jchi2) <= 1e-8 * jchi2, loss
        assert abs(tate_ - jate_) <= 1e-6 * jate_, loss
        ates[loss] = tate_
    for loss in ("huber", "cauchy", "tukey"):
        assert ates[loss] < ates["none"], (loss, ates)
    assert min(ates["cauchy"], ates["tukey"]) < 0.5 * ates["none"]


def _all_losses_reachable(path, gt):
    for loss in LOSSES:
        (jchi2, _), (tchi2, _) = _robust_run(path, gt, {"edge_pose3d": (loss, 0.3)}, 2)
        assert np.isfinite(tchi2), loss
        assert abs(tchi2 - jchi2) <= 1e-8 * jchi2, loss


def _type_registry_defaults_apply(path, gt):
    (jdef, _), (tdef, _) = _robust_run(path, gt, None, 5)
    (_, _), (texp, _) = _robust_run(path, gt, {"edge_pose3d": ("huber", 0.3)}, 5)
    assert tdef == pytest.approx(texp, rel=1e-12)
    assert abs(tdef - jdef) <= 1e-8 * jdef


@pytest.mark.parametrize("case", [_robust_losses_beat_plain, _all_losses_reachable,
                                  _type_registry_defaults_apply],
                         ids=lambda f: f.__name__.strip("_"))
def test_robust_overrides_match_jax(corrupted_sphere, case):
    case(*corrupted_sphere)


def test_robust_overrides_reject_an_unknown_loss():
    with pytest.raises(ValueError, match="not one of"):
        SolverSettings(robust_overrides={"*": ("bogus", 1.0)})


# ---- damping_init and optimize_lm -------------------------------------------

@pytest.fixture(scope="module")
def ba_file(tmp_path_factory):
    cams, pts, obs = jds.make_ba_scene(n_cams=6, n_points=80, seed=21)
    p = str(tmp_path_factory.mktemp("lm") / "ba.g2o")
    jds.write_g2o_ba(p, cams, pts, obs)
    return p


@pytest.mark.parametrize("damping", [0.0, 50.0])
def test_optimize_lm_with_damping_init(ba_file, damping):
    """optimize_lm from the derived alpha and from damping_init, both
    packages: chi2, iterations and the solved states."""
    js, ts = jparse(ba_file), tparse(ba_file)
    jchi2, jit = joptimize_lm(js, SolverConfig(damping_init=damping), 5, 0.01)
    tchi2, tit = toptimize_lm(ts, device="cpu", settings=SolverSettings(damping_init=damping),
                              max_iterations=5, dx_threshold=0.01)
    assert tit == jit
    assert abs(tchi2 - jchi2) <= 1e-8 * jchi2
    for t in ("cam", "xyz"):
        assert _rel(ts.vertex_stores[t].data, js.vertex_stores[t].data) <= 1e-8


# ---- marginals: sigma_blocks and omega_sqrt_for_edge -----------------------------

@pytest.fixture(scope="module")
def manhattan(tmp_path_factory):
    poses, edges = jds.make_manhattan_2d(n_poses=80, seed=33)
    p = str(tmp_path_factory.mktemp("marg") / "m.txt")
    jds.write_g2o_2d(p, edges, poses)
    return p


def test_sigma_blocks_match_jax(manhattan):
    """Sigma on lambda's pattern in the assembler's pair order (the sparse
    recurrent recovery), off-diagonal blocks included; other routes
    refuse, as in the JAX package."""
    js, ts = jparse(manhattan), tparse(manhattan)
    ja, ta = JAssembler(js), TAssembler(ts, device="cpu")
    jbs, tbs = ja.assemble(ja.snapshot_states(js)), ta.assemble(ta.snapshot_states(ts))
    want = np.asarray(JMarginals(ja, mode="sparse").sigma_blocks(jbs))
    got = Marginals(ta, mode="sparse").sigma_blocks(tbs).numpy()
    assert got.shape == want.shape == (len(ta.pp_rows), 9)
    assert _rel(got, want) <= 1e-9
    with pytest.raises(ValueError, match="mode='sparse'"):
        Marginals(ta).sigma_blocks(tbs)


def test_omega_sqrt_for_edge_matches_jax(manhattan):
    """One edge's G columns (G G^T its omega) at the parsed states."""
    js, ts = jparse(manhattan), tparse(manhattan)
    ja, ta = JAssembler(js), TAssembler(ts, device="cpu")
    for eidx in (0, 7, ts.edge_stores["edge_pose2d"].n - 1):
        want = np.asarray(JIncMarg.omega_sqrt_for_edge(ja, ja.snapshot_states(js),
                                                       "edge_pose2d", eidx))
        got = IncrementalMarginals.omega_sqrt_for_edge(ta, ta.snapshot_states(ts),
                                                       "edge_pose2d", eidx).numpy()
        assert got.shape == want.shape == (ta.Np * ta.Bp, 3)
        assert _rel(got, want) <= 1e-12


# ---- the view-direction transform and the association app ------------------------

def test_view_direction_transform_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(6):
        mean = np.concatenate([rng.normal(0, 2, 3), rng.normal(0, 0.8, 3)])
        A = rng.normal(size=(6, 6))
        sigma = A @ A.T + 0.1 * np.eye(6)
        jm, js = jdist.view_direction_transform(mean, sigma)
        tm, ts = tdist.view_direction_transform(mean, sigma)
        assert _rel(tm, jm) <= 1e-12
        assert _rel(ts, js) <= 1e-12


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    poses, edges = jds.make_sphere_3d(n_poses=48, trans_noise=0.01, rot_noise=0.005, seed=4)
    p = str(tmp_path_factory.mktemp("assoc") / "sph.txt")
    jds.write_g2o_3d(p, edges, poses)
    return p


def test_association_gate_and_transform_match_jax(sphere):
    """run_association(gate=, transform="view_direction"): each candidate's
    mean4, squared distance and decision against the JAX package's
    view-direction transform and gate over the port's maintained posterior
    (the JAX FastL maintains another one on SE(3) graphs:
    tests/test_torch_marginals.py)."""
    gate = (0.8, 0.8, 0.8, 0.2)
    system = tparse(sphere)
    n = len(system.vertex_order)
    query = system.vertex_order[-1]
    candidates = system.vertex_order[:-1][::max(1, n // 12)]
    decisions, sv = dataassoc_example.run_association(
        system, query, candidates, gate=gate, transform="view_direction", device="cpu")
    sig = sv.sigma_diag().numpy()

    def pose_and_sigma(gid):
        tname, li = system.vertex_directory[gid]
        return system.vertex_stores[tname].data[li], sig[int(sv.asm.type_cslot[tname][li])]

    xq, sq = pose_and_sigma(query)
    for (cid, m4, ok, d2) in decisions:
        xc, sc = pose_and_sigma(cid)
        jm4, js4 = jdist.view_direction_transform(
            *jdist.relative_pose_distribution(xq, xc, sq, sc))
        js4 = js4 + 1e-9 * np.eye(4)
        assert _rel(m4, jm4) <= 1e-10
        assert abs(d2 - jdist.mahalanobis_distance2(jm4, js4)) <= 1e-9 * d2
        assert ok == jdist.mahalanobis_gate(jm4, js4, np.array(gate))
    with pytest.raises(ValueError, match="transform"):
        dataassoc_example.run_association(system, query, candidates, transform="bogus",
                                          device="cpu")


# ---- GraphSystem ------------------------------------------------------------------

def test_graph_system_members_match_jax(sphere, tmp_path):
    js, ts = jparse(sphere), tparse(sphere)
    assert ts.summary() == js.summary()
    for g in (0, 17, 47, 48, -1):
        assert ts.has_vertex(g) == js.has_vertex(g)
    for g in (0, 17, 47):
        assert ts.block_index(g) == js.block_index(g)
    (to, tn), (jo, jn) = ts.tangent_offsets(), js.tangent_offsets()
    assert tn == jn and np.array_equal(to, jo)
    state = np.array([1.0, 2.0, 3.0, 0.1, -0.2, 0.3])
    ts.set_vertex_state(5, state)
    js.set_vertex_state(5, state)
    assert np.array_equal(ts.vertex_state(5), state)
    ts.dump(str(tmp_path / "t.txt"))
    js.dump(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


# ---- so3 --------------------------------------------------------------------------

def test_rotmat_to_quat_and_axis_angle_match_jax():
    """Random rotations and the branch edges of Shepperd's method (the
    identity, angles near pi about each axis), batched in the port, one at
    a time in the JAX package."""
    rng = np.random.default_rng(3)
    aa = [rng.normal(0, 1.2, 3) for _ in range(20)]
    aa += [np.zeros(3)] + [(np.pi - 1e-3) * e for e in np.eye(3)]
    aa = np.stack(aa)
    R = np.stack([np.asarray(jso3.axis_angle_to_rotmat(jnp.asarray(a))) for a in aa])
    jq = np.stack([np.asarray(jso3.rotmat_to_quat(jnp.asarray(r))) for r in R])
    ja = np.stack([np.asarray(jso3.rotmat_to_axis_angle(jnp.asarray(r))) for r in R])
    tq = tso3.rotmat_to_quat(torch.as_tensor(R)).numpy()
    ta = tso3.rotmat_to_axis_angle(torch.as_tensor(R)).numpy()
    assert _rel(tq, jq) <= 1e-12
    assert _rel(ta, ja) <= 1e-12
    assert _rel(tso3.axis_angle_to_rotmat(torch.as_tensor(ta)).numpy(), R) <= 1e-12
    assert jax.config.jax_enable_x64
