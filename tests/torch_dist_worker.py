"""One rank of the port's distributed cases, run as its own process by
tests/test_torch_parallel.py (gloo over a FileStore, CPU, float64):

    python tests/torch_dist_worker.py RANK WORLD STORE SCENE_DIR OUT_DIR

It imports torch and the port only, never JAX: the parent test compares
what each rank writes to OUT_DIR/rank<RANK>.npz with the JAX package's
sharded results and the port's single-process ones.  The scene files are
the parent's; the Sim(3) scene is built here by ``sim3_lists`` (the parent
builds the JAX package's system from the same lists)."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: block-system fields compared by the assembly cases
FIELDS = ("pp_blocks", "pl_blocks", "ll_blocks", "eta_p", "eta_l", "chi2", "max_hdiag")
#: the sharded BA cases: scene file (or "sim3") -> damped steps
SHARDED_STEPS = 3


def sim3_lists():
    """The JAX test's scene of two Sim(3) landmark types (inv_depth, 3 dof,
    and inv_dist4, 1 dof; test_sharded_ba.py::test_sharded_multi_landmark_types)
    as (vertices, edges) lists, the measurements at zero residual from the
    port's own edge types plus seeded noise."""
    from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES
    import slam_plus_plus_tpu_torch.models  # noqa: F401

    rng = np.random.default_rng(5)
    n_cams = 4
    cams = [np.array([0.3 * c, 0.05 * c, 0.0, 0.0, 0.0, 0.02 * c, 1.0,
                      500.0, 500.0, 320.0, 240.0, 0.0]) for c in range(n_cams)]
    vertices = [(c, "cam_sim3", cams[c]) for c in range(n_cams)]
    edges = []
    for i in range(24):
        depth = i % 2 == 0
        ename = "edge_p2c_invdepth_ls" if depth else "edge_p2c_invdist_ls"
        owner, nv = i % n_cams, n_cams + i
        if depth:
            lm_true, tname = np.array([0.1 * i - 1.0, 0.05 * i - 0.5, 0.22]), "inv_depth"
        else:
            lm_true = np.array([0.1 * i - 1.0, 0.05 * i - 0.5, 1.0, 0.21])
            tname = "inv_dist4"
        st = (torch.tensor(cams[owner])[None], torch.tensor(lm_true)[None])
        z_true = -EDGE_TYPES[ename].residual(st, torch.zeros((1, 2), dtype=torch.float64))[0]
        # the LS edges observe from their owner only: one edge per landmark
        edges.append((ename, (owner, nv), z_true.numpy() + rng.normal(0, 0.5, 2), np.eye(2)))
        vertices.append((nv, tname, lm_true + rng.normal(0, 0.02, lm_true.shape)))
    return vertices, edges


def _sharded_steps(opt, out, key):
    """SHARDED_STEPS damped steps: chi2 per step, final camera states and
    this rank's landmark rows."""
    cam, xyz = opt._cam_snapshot(), opt.xyz
    chis = []
    for _ in range(SHARDED_STEPS):
        cam, xyz, chi2 = opt.step(cam, xyz)
        chis.append(float(chi2))
    out[f"{key}_chi2"] = np.array(chis)
    for t, v in cam.items():
        out[f"{key}_cam_{t}"] = v.numpy()
    out[f"{key}_xyz"] = xyz.numpy()
    out[f"{key}_locals"] = opt._l_locals


def main(rank, world, store, scene_dir, out_dir):
    import torch.distributed as dist

    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.graph.system import GraphSystem
    from slam_plus_plus_tpu_torch.io.datasets import fill_system
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver
    from slam_plus_plus_tpu_torch.parallel import (
        DistributedAssembler, DistributedBlockCholeskySolver, DistributedSchurSolver,
        ShardedBAOptimizer, multihost)
    from slam_plus_plus_tpu_torch.solvers.lm import damp_system
    from slam_plus_plus_tpu_torch.utils.flops import torch_cost

    assert multihost.initialize(f"file://{store}", world, rank, device="cpu", timeout_s=120)
    # one-rank groups: the world-size-1 runs of the same classes
    solo = [dist.new_group([r]) for r in range(world)][rank]

    def scene(name):
        return parse_g2o(os.path.join(scene_dir, name))

    out = {"summary": multihost.process_summary()}
    # edge-sharded assembly (flat layout), and the full damped step through it
    for name in ("man", "ba"):
        system = scene(f"{name}.g2o")
        asm = DistributedAssembler(system, device="cpu")
        bs = asm.assemble(asm.snapshot_states(system))
        for f in FIELDS:
            out[f"asm_{name}_{f}"] = getattr(bs, f).numpy()
        out[f"asm_{name}_chi2fn"] = float(asm.chi2(asm.snapshot_states(system)))
    system = scene("step.g2o")
    asm = DistributedAssembler(system, device="cpu")
    st = asm.snapshot_states(system)
    bs = asm.assemble(st)
    bs = damp_system(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)
    for t, v in asm.update(st, *SchurSolver(asm).solve(bs)).items():
        out[f"step_{t}"] = v.numpy()

    # the sharded Schur panel products, and their FLOPs at 1 and `world` ranks
    system = scene("schur.g2o")
    asm = Assembler(system, device="cpu")
    bs = asm.assemble(asm.snapshot_states(system))
    bs = damp_system(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)
    dx_p, dx_l = DistributedSchurSolver(asm).solve(bs)
    out["schur_dx_p"], out["schur_dx_l"] = dx_p.numpy(), dx_l.numpy()
    system = scene("flops.g2o")
    asm = Assembler(system, device="cpu")
    bs = asm.assemble(asm.snapshot_states(system))
    for n, group in ((1, solo), (world, None)):
        ds = DistributedSchurSolver(asm, group=group)
        out[f"flops_{n}"] = torch_cost(ds.solve, bs)["flops"]

    # the distributed MIS block Cholesky
    system = scene("chol.g2o")
    asm = Assembler(system, device="cpu")
    bs = asm.assemble(asm.snapshot_states(system))
    chol = DistributedBlockCholeskySolver(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp,
                                          device="cpu", bottom=32)
    out["chol_levels"] = chol.n_levels
    out["chol_dx"] = chol.solve(bs.pp_blocks, bs.eta_p).numpy()
    out["chol_dx_f"] = chol.solve_with_factor(chol.factor(bs.pp_blocks), bs.eta_p).numpy()

    # landmark-sharded BA
    for key in ("sba", "mixed"):
        _sharded_steps(ShardedBAOptimizer(scene(f"{key}.g2o"), device="cpu", damping=1e-3),
                       out, key)
    opt = ShardedBAOptimizer(fill_system(GraphSystem(), *sim3_lists()), device="cpu")
    out["sim3_l_types"] = np.array(opt.l_types)
    _sharded_steps(opt, out, "sim3")
    for n, group in ((1, solo), (world, None)):
        opt = ShardedBAOptimizer(scene("state.g2o"), device="cpu", group=group)
        out[f"state_{n}_rows"] = np.array([opt.G, opt.Nl_pad, opt.xyz.shape[0],
                                           opt.plan_data[0]["z"].shape[0], opt.plan_data[0]["M"]])
        for k, v in opt.per_device_bytes().items():
            out[f"state_{n}_{k}"] = v
    opt = ShardedBAOptimizer(scene("opt.g2o"), device="cpu")
    out["opt_chi2"] = opt.optimize(7)[0]
    opt.writeback()
    out["opt_final_chi2"] = float(Assembler(opt.system, device="cpu").chi2(
        Assembler(opt.system, device="cpu").snapshot_states(opt.system)))
    if os.path.exists(os.path.join(scene_dir, "venice.g2o")):
        # venice-real's shape (SLAMPP_SLOW), float32, as the JAX test runs it
        opt = ShardedBAOptimizer(scene("venice.g2o"), device="cpu", dtype=torch.float32)
        out["venice_rows"] = np.array([opt.G, opt.xyz.shape[0]])
        out["venice_total"] = opt.per_device_bytes()["total"]
        out["venice_chi2"] = np.array([opt.optimize(1)[0], opt.optimize(1)[0]])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    main(rank, world, *sys.argv[3:6])
