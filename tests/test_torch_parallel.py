"""Port parity for parallel/: the edge-sharded assembly and Schur panel
products, the distributed MIS block Cholesky and the landmark-sharded BA,
each run on 2 gloo ranks of the port (CPU, float64) against the JAX
package's sharded result on a 2-device mesh and the single-process result
of each package, on the same files.

One world of 2 ranks per module: tests/torch_dist_worker.py runs every
case on each rank (own processes, rendezvous through a FileStore under the
test's temporary directory) and writes its arrays to an .npz file; the tests
here compare them.  Also: item 11's uniform edge layout against the flat
one on the mixed P2MCI + stereo and the Sim(3) scenes."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem as JSystem
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.schur import SchurSolver as JSchur
from slam_plus_plus_tpu.solvers.lm import damp_system as jdamp
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.graph.system import GraphSystem as TSystem
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver as TBC
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver as TSchur
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver as TGN
from slam_plus_plus_tpu_torch.solvers.lm import damp_system as tdamp

WORLD = 2
HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dist_worker.py")
_spec = importlib.util.spec_from_file_location("torch_dist_worker", WORKER)
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)


def _scenes(d):
    """The JAX tests' scenes, written by the JAX package's generators."""
    poses, edges = jds.make_manhattan_2d(n_poses=100, seed=101)
    jds.write_g2o_2d(os.path.join(d, "man.g2o"), edges, poses)
    for name, (n_cams, n_points, seed) in {
            "ba": (5, 40, 102), "step": (5, 40, 103), "schur": (12, 160, 111),
            "flops": (20, 600, 112), "sba": (6, 60, 7), "state": (8, 160, 8),
            "opt": (6, 80, 9)}.items():
        jds.write_g2o_ba(os.path.join(d, f"{name}.g2o"),
                         *jds.make_ba_scene(n_cams=n_cams, n_points=n_points, seed=seed))
    poses, edges = jds.make_manhattan_2d(n_poses=600, seed=31, loop_prob=0.3)
    jds.write_g2o_2d(os.path.join(d, "chol.g2o"), edges, poses)
    cams, pts, mono = jds.make_ba_scene(n_cams=8, n_points=80, seed=21)
    jds.write_g2o_ba_mixed(os.path.join(d, "mixed.g2o"), cams, pts, mono,
                           jds.make_ba_stereo_obs(cams, pts, seed=22))
    if os.environ.get("SLAMPP_SLOW"):
        jds.write_g2o_ba(os.path.join(d, "venice.g2o"), *jds.make_ba_scene_large(
            n_cams=871, n_points=100000, obs_per_point=8, seed=5))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(scene dir, [rank 0's arrays, rank 1's]) of one 2-rank world."""
    d = str(tmp_path_factory.mktemp("parallel"))
    _scenes(d)
    store = os.path.join(d, "store")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), store, d, d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=900)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)[-6000:]
    return d, [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(WORLD)]


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0)


def _flat():
    return dataclasses.replace(SolverConfig(), edge_layout="flat")


@pytest.mark.parametrize("family", ["man", "ba"])
def test_distributed_assembly_matches(world, family):
    """Every rank's replicated block system equals the single-process flat
    assembly of the port and the JAX package's DistributedAssembler on a
    2-device mesh, at 1e-9 x scale (the sums run in another order)."""
    from slam_plus_plus_tpu.parallel import DistributedAssembler, make_edge_mesh

    d, ranks = world
    path = os.path.join(d, f"{family}.g2o")
    js = jparse(path)
    jb = DistributedAssembler(js, make_edge_mesh(WORLD)).assemble(
        JAssembler(js, _flat()).snapshot_states(js))
    ts = tparse(path)
    ta = TAssembler(ts, device="cpu", settings=SolverSettings(edge_layout="flat"))
    tb = ta.assemble(ta.snapshot_states(ts))
    for name in worker.FIELDS:
        for r in ranks:
            got = r[f"asm_{family}_{name}"]
            assert _rel(got, np.asarray(getattr(jb, name))) < 1e-9, name
            assert _rel(got, getattr(tb, name).numpy()) < 1e-9, name
    for r in ranks:
        assert abs(r[f"asm_{family}_chi2fn"] - float(tb.chi2)) < 1e-9 * max(float(tb.chi2), 1)


def test_distributed_full_step(world):
    """One damped GN / Schur step through the distributed assembler equals
    the single-process step of both packages (1e-8 x scale, the JAX test's)."""
    from slam_plus_plus_tpu.parallel import DistributedAssembler, make_edge_mesh

    d, ranks = world
    path = os.path.join(d, "step.g2o")

    def jstep(asm, system):
        st = asm.snapshot_states(system)
        bs = asm.assemble(st)
        bs = jdamp(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)
        return {k: np.asarray(v) for k, v in asm.update(st, *JSchur(asm).solve(bs)).items()}

    js = jparse(path)
    j8 = jstep(DistributedAssembler(js, make_edge_mesh(WORLD)), js)
    ts = tparse(path)
    ta = TAssembler(ts, device="cpu")
    st = ta.snapshot_states(ts)
    bs = ta.assemble(st)
    bs = tdamp(bs, float(bs.max_hdiag) * 1e-3, ta.pp_diag_ids_dev)
    t1 = {k: v.numpy() for k, v in ta.update(st, *TSchur(ta).solve(bs)).items()}
    for k in t1:
        for r in ranks:
            assert _rel(r[f"step_{k}"], t1[k]) < 1e-8, k
            assert _rel(r[f"step_{k}"], j8[k]) < 1e-8, k


def test_distributed_schur_matches_single(world):
    """The sharded SC panel products + all_reduce against the single-process
    Schur solve of both packages and the JAX DistributedSchurSolver: dx_p
    at 1e-9 x scale, dx_l at 1e-8 (the JAX test's bounds)."""
    from slam_plus_plus_tpu.parallel import make_edge_mesh
    from slam_plus_plus_tpu.parallel.dist import DistributedSchurSolver as JDist

    d, ranks = world
    path = os.path.join(d, "schur.g2o")
    js = jparse(path)
    ja = JAssembler(js)
    jb = ja.assemble(ja.snapshot_states(js))
    jb = jdamp(jb, float(jb.max_hdiag) * 1e-3, ja.pp_diag_ids_dev)
    jdist = [np.asarray(x) for x in JDist(ja, make_edge_mesh(WORLD)).solve(jb)]
    ts = tparse(path)
    ta = TAssembler(ts, device="cpu")
    tb = ta.assemble(ta.snapshot_states(ts))
    tb = tdamp(tb, float(tb.max_hdiag) * 1e-3, ta.pp_diag_ids_dev)
    single = [x.numpy() for x in TSchur(ta).solve(tb)]
    scale = max(np.abs(single[0]).max(), 1e-12)
    for r in ranks:
        for want in (single, jdist):
            assert np.abs(r["schur_dx_p"] - want[0]).max() < 1e-9 * scale
            assert np.abs(r["schur_dx_l"] - want[1]).max() < 1e-8


def test_distributed_schur_flops_split(world):
    """The FLOPs one rank runs (PyTorch's count of the whole solve, the
    replicated reduced factor included) drop with the rank count: 2-rank
    efficiency flops(1) / (2 flops(2)) >= 0.7, the JAX test's gate."""
    _d, ranks = world
    for r in ranks:
        eff = r["flops_1"] / (WORLD * r[f"flops_{WORLD}"])
        assert eff >= 0.7, (r["flops_1"], r[f"flops_{WORLD}"], eff)


def test_distributed_pose_graph_cholesky(world):
    """The distributed MIS-Schur factor (W slices all-gathered, fill
    products all-reduced per level) solves as the port's single-process
    factor at 1e-10 relative (the JAX test's bound; on the CPU the port's
    split sums each block in the single-process order, so the two agree to
    the bit), and its replicated factor serves solve_with_factor.  Against
    the JAX package's distributed factor: 1e-8 relative, the bound the two
    packages' single-process factors meet on this lambda (float64 rounding
    amplified by its condition: they differ by 4.0e-9)."""
    from slam_plus_plus_tpu.linalg.block_cholesky import BlockCholeskySolver as JBC
    from slam_plus_plus_tpu.parallel import DistributedBlockCholeskySolver as JDC
    from slam_plus_plus_tpu.parallel import make_edge_mesh

    d, ranks = world
    path = os.path.join(d, "chol.g2o")
    js = jparse(path)
    ja = JAssembler(js)
    jb = ja.assemble(ja.snapshot_states(js))
    jdc = JDC(ja.pp_rows, ja.pp_cols, ja.Np, ja.Bp, make_edge_mesh(WORLD), bottom=32)
    jdx = np.asarray(jdc.solve(jb.pp_blocks, jb.eta_p))
    ts = tparse(path)
    ta = TAssembler(ts, device="cpu")
    tb = ta.assemble(ta.snapshot_states(ts))
    single = TBC(ta.pp_rows, ta.pp_cols, ta.Np, ta.Bp, device="cpu", bottom=32)
    dx1 = single.solve(tb.pp_blocks, tb.eta_p).numpy()
    denom = max(np.abs(dx1).max(), 1e-12)
    jdx1 = np.asarray(JBC(ja.pp_rows, ja.pp_cols, ja.Np, ja.Bp, bottom=32).solve(
        jb.pp_blocks, jb.eta_p))
    assert np.abs(jdx1 - dx1).max() / denom < 1e-8
    assert np.abs(jdx1 - jdx).max() / denom < 1e-10
    for r in ranks:
        assert int(r["chol_levels"]) == single.n_levels == jdc.n_levels >= 3
        for key in ("chol_dx", "chol_dx_f"):
            assert np.abs(r[key] - dx1).max() / denom < 1e-10, key
            assert np.array_equal(r[key], dx1), key
            assert np.abs(r[key] - jdx).max() / denom < 1e-8, key


def _single_trace(system, settings=None):
    """3 damped GN steps of the port's single-process solve: (chi2 per
    step, final states)."""
    asm = TAssembler(system, device="cpu", settings=settings)
    schur = TSchur(asm)
    states = asm.snapshot_states(system)
    chis = []
    for _ in range(worker.SHARDED_STEPS):
        bs = asm.assemble(states)
        chis.append(float(bs.chi2))
        bs = tdamp(bs, bs.max_hdiag * 1e-3, asm.pp_diag_ids_dev)
        states = asm.update(states, *schur.solve(bs))
    return np.array(chis), {k: v.numpy() for k, v in states.items()}


def _jax_sharded_trace(system):
    from slam_plus_plus_tpu.parallel import ShardedBAOptimizer, make_lm_mesh

    opt = ShardedBAOptimizer(system, make_lm_mesh(WORLD), damping=1e-3)
    cam, xyz = opt._cam_snapshot(), opt.xyz
    chis = []
    for _ in range(worker.SHARDED_STEPS):
        cam, xyz, chi2 = opt._step(cam, xyz, opt._l_mask, opt._type_rows,
                                   opt._tree_of_plans())
        chis.append(float(chi2))
    return np.array(chis)


def _check_sharded(ranks, key, single, jax_chis, l_type=None, tol=1e-6):
    """Each rank's chi2 trace against the single-process and the JAX
    sharded traces; with l_type, also the states against the single-process
    ones: the cameras replicated on each rank, the ranks' landmark rows
    (class-slot order) together the landmark states."""
    want_chis, states = single
    for r in ranks:
        assert np.all(np.abs(r[f"{key}_chi2"] - want_chis) <= tol * np.maximum(want_chis, 1.0))
        assert np.all(np.abs(r[f"{key}_chi2"] - jax_chis) <= tol * np.maximum(jax_chis, 1.0))
    if l_type is None:
        return
    for t in states:
        if t != l_type:
            for r in ranks:
                assert _rel(r[f"{key}_cam_{t}"], states[t]) < tol, t
    locals_ = ranks[0][f"{key}_locals"]
    xyz = np.concatenate([r[f"{key}_xyz"] for r in ranks])[:len(locals_)]
    assert _rel(xyz, states[l_type][locals_]) < tol


def test_sharded_step_matches_single_device(world):
    """3 landmark-sharded damped steps (2 ranks) against the single-process
    step of the port and the JAX ShardedBAOptimizer on a 2-device mesh:
    chi2 per step and the states at 1e-6 relative (the JAX test's)."""
    d, ranks = world
    path = os.path.join(d, "sba.g2o")
    _check_sharded(ranks, "sba", _single_trace(tparse(path)), _jax_sharded_trace(jparse(path)),
                   l_type="xyz")


def test_sharded_state_is_actually_sharded(world):
    """Each rank holds only its G = ceil(Nl / 2) landmark rows and G * M
    edge slots, and the estimate of its device bytes keeps the replicated
    part and halves the sharded part against one rank (slack 1.3, the JAX
    test's)."""
    _d, ranks = world
    for r in ranks:
        G, Nl_pad, rows, z_rows, M = r[f"state_{WORLD}_rows"]
        assert Nl_pad == WORLD * G and rows == G and z_rows == G * M
        G1, _pad1, rows1, _z1, _m1 = r["state_1_rows"]
        assert rows1 == G1 == Nl_pad and G1 == WORLD * G
        assert r[f"state_{WORLD}_replicated"] == r["state_1_replicated"]
        assert r[f"state_{WORLD}_sharded"] < r["state_1_sharded"] / WORLD * 1.3


def test_sharded_optimize_converges(world):
    """optimize(7) (the chi2 before its last update) within 1.05 x the
    port's single-process GN after 6 iterations; after writeback the
    system's chi2 is at most that."""
    d, ranks = world
    ref, _ = TGN(tparse(os.path.join(d, "opt.g2o")), device="cpu").optimize(6)
    for r in ranks:
        assert r["opt_chi2"] <= ref * 1.05
        assert r["opt_final_chi2"] <= r["opt_chi2"]


def test_sharded_mixed_p2ci_stereo(world):
    """Ternary P2MCI edges (a shared intrinsics vertex) and stereo edges
    shard and match the single-process chi2 trace of the port and the JAX
    sharded one (1e-6)."""
    d, ranks = world
    path = os.path.join(d, "mixed.g2o")
    assert len(tparse(path).edge_stores) == 2
    _check_sharded(ranks, "mixed", _single_trace(tparse(path)),
                   _jax_sharded_trace(jparse(path)), l_type="xyz")


def test_sharded_multi_landmark_types(world):
    """Two Sim(3) landmark vertex types (inv_depth and inv_dist4) shard
    through per-type updates of the shared rows and match the
    single-process chi2 trace of the port and the JAX sharded one (1e-6)."""
    from slam_plus_plus_tpu_torch.io.datasets import fill_system

    _d, ranks = world
    lists = worker.sim3_lists()
    for r in ranks:
        assert list(r["sim3_l_types"]) == ["inv_depth", "inv_dist4"]
    _check_sharded(ranks, "sim3", _single_trace(fill_system(TSystem(), *lists)),
                   _jax_sharded_trace(fill_system(JSystem(), *lists)))


@pytest.mark.skipif(not os.environ.get("SLAMPP_SLOW"),
                    reason="venice-real scale: minutes on the CPU (SLAMPP_SLOW=1)")
def test_sharded_venice_real(world):
    """871 cameras / 100,000 points / 800,000 observations in float32 over
    2 ranks: each holds G = 50,000 landmark rows, its estimate stays under
    the JAX test's 2.5e9 bytes per device at 8 (here 2) ranks x 4, and two
    optimize(1) calls descend."""
    _d, ranks = world
    for r in ranks:
        G, rows = r["venice_rows"]
        assert G == rows == 100000 // WORLD
        assert r["venice_total"] < 2.5e9 * 8 / WORLD
        c1, c2 = r["venice_chi2"]
        assert np.isfinite(c2) and c2 < c1


@pytest.mark.parametrize("scene", ["mixed", "sim3"])
def test_uniform_layout_matches_flat(world, scene):
    """edge_layout="uniform" on every landmark edge type (ROADMAP item 11):
    the block system equals the JAX package's uniform assembly block for
    block and, summed per (camera, landmark) pair, the port's flat assembly
    (both 1e-10 x scale, the float64 parity bound of the Sim(3) tests: the
    two packages' forward-mode Jacobians round apart by up to 6.5e-12); a
    damped Schur step through it equals the flat one's (1e-9)."""
    from slam_plus_plus_tpu_torch.io.datasets import fill_system

    d, _ranks = world
    if scene == "mixed":
        path = os.path.join(d, "mixed.g2o")
        tsys, jsys = tparse(path), jparse(path)
    else:
        lists = worker.sim3_lists()
        tsys, jsys = fill_system(TSystem(), *lists), fill_system(JSystem(), *lists)
    tu = TAssembler(tsys, device="cpu", settings=SolverSettings(edge_layout="uniform"))
    tf = TAssembler(tsys, device="cpu", settings=SolverSettings(edge_layout="flat"))
    ju = JAssembler(jsys, dataclasses.replace(SolverConfig(), edge_layout="uniform"))
    assert len(tu.pl_uniform) == len(ju.pl_uniform) and tf.pl_uniform is None
    assert [c["M"] for c in tu.pl_uniform] == [c["M"] for c in ju.pl_uniform]
    st = tu.snapshot_states(tsys)
    bu, bf = tu.assemble(st), tf.assemble(st)
    jb = ju.assemble(ju.snapshot_states(jsys))
    for name in worker.FIELDS:
        assert _rel(getattr(bu, name).numpy(), np.asarray(getattr(jb, name))) < 1e-10, name
    for name in ("pp_blocks", "ll_blocks", "eta_p", "eta_l", "chi2", "max_hdiag"):
        assert _rel(getattr(bu, name).numpy(), getattr(bf, name).numpy()) < 1e-10, name

    def per_pair(asm, bs):
        out = {}
        for r, c, blk in zip(asm.pl_rows, asm.pl_cols, bs.pl_blocks.numpy()[:asm.Kpl]):
            out[(r, c)] = out.get((r, c), 0.0) + blk
        return out

    pu, pf = per_pair(tu, bu), per_pair(tf, bf)
    assert set(pf) <= set(pu)
    scale = max(np.abs(v).max() for v in pf.values())
    assert max(np.abs(pu[k] - pf.get(k, 0.0)).max() for k in pu) < 1e-10 * scale
    steps = []
    for asm, bs in ((tu, bu), (tf, bf)):
        sch = TSchur(asm)
        assert not sch.uniform
        bs = tdamp(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)
        steps.append(sch.solve(bs))
    for u, f in zip(*steps):
        assert _rel(u.numpy(), f.numpy()) < 1e-9
