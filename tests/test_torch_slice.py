"""Port parity for the BA main path as a whole: the damped Schur step that
bench.py times, the Lambda-LM loop and the CLI, on both packages, float64
on the CPU.  Also: the port never imports JAX, and its kernel wrappers never
fall back to the plain version for a CUDA tensor."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.schur import SchurSolver as JSchur
from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slam_plus_plus_tpu.solvers.lm import damp_system as jdamp
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver as TSchur
from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
from slam_plus_plus_tpu_torch.ops.panel import build_panels
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver as TLM
from slam_plus_plus_tpu_torch.solvers.lm import damp_system as tdamp


@pytest.fixture(scope="module")
def ba_file(tmp_path_factory):
    cams, pts, obs = jds.make_ba_scene(n_cams=8, n_points=200, seed=31)
    p = str(tmp_path_factory.mktemp("slice") / "ba.g2o")
    jds.write_g2o_ba(p, cams, pts, obs)
    return p


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1.0)


def test_damped_schur_steps_match(ba_file):
    """Two steps of bench.py's step (assemble, damp by 1e-3 max_hdiag, Schur
    solve, update) on both packages, from the same states."""
    js, ts = jparse(ba_file), tparse(ba_file)
    ja, ta = JAssembler(js), TAssembler(ts, device="cpu")
    jsch, tsch = JSchur(ja), TSchur(ta)
    jst = ja.snapshot_states(js)
    tst = ta.states_from_numpy({k: np.asarray(v) for k, v in jst.items()})
    for _ in range(2):
        jb = ja.assemble(jst)
        jb = jdamp(jb, jb.max_hdiag * jnp.asarray(1e-3), ja.pp_diag_ids_dev)
        tb = ta.assemble(tst)
        tb = tdamp(tb, tb.max_hdiag * 1e-3, ta.pp_diag_ids_dev)
        jdx, tdx = jsch.solve(jb), tsch.solve(tb)
        for w, g in zip(jdx, tdx):
            assert _rel(g, w) <= 1e-9
        jst, tst = ja.update(jst, *jdx), ta.update(tst, *tdx)
        for t in jst:
            assert _rel(tst[t], jst[t]) <= 1e-9, t


def test_flat_schur_branch_on_the_uniform_layout(ba_file, monkeypatch):
    """Uniform BA panels past UNIFORM_PANEL_BYTES take the flat branch, as in
    the JAX package: its damped Schur step (the dummy slots' zero blocks
    summed in) equals the JAX package's uniform one."""
    from slam_plus_plus_tpu_torch.linalg import schur as tschur
    monkeypatch.setattr(tschur, "UNIFORM_PANEL_BYTES", 0)
    js, ts = jparse(ba_file), tparse(ba_file)
    ja, ta = JAssembler(js), TAssembler(ts, device="cpu")
    assert ta.pl_uniform is not None
    tsch = TSchur(ta)
    assert not tsch.uniform
    jst = ja.snapshot_states(js)
    tst = ta.states_from_numpy({k: np.asarray(v) for k, v in jst.items()})
    jb = ja.assemble(jst)
    jb = jdamp(jb, jb.max_hdiag * jnp.asarray(1e-3), ja.pp_diag_ids_dev)
    tb = ta.assemble(tst)
    tb = tdamp(tb, tb.max_hdiag * 1e-3, ta.pp_diag_ids_dev)
    for w, g in zip(JSchur(ja).solve(jb), tsch.solve(tb)):
        assert _rel(g, w) <= 1e-9


@pytest.fixture(scope="module")
def jax_lm(ba_file):
    """The JAX LM run: (final chi2, iterations, per-trial (|dx|, chi2, denom)),
    read off the one device_get per trial of its loop."""
    log = []
    real_get = jax.device_get

    def spy(x):
        out = real_get(x)
        if isinstance(x, tuple) and len(x) == 3:
            log.append(tuple(float(v) for v in out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_get", spy)
        chi2, iters = JLM(jparse(ba_file)).optimize(5, 0.01)
    return chi2, iters, log


def test_lm_trajectory_matches(ba_file, jax_lm):
    jchi2, jit, jlog = jax_lm
    tlm = TLM(tparse(ba_file), device="cpu")
    tchi2, tit = tlm.optimize(5, 0.01)
    assert tit == jit
    assert len(tlm.trial_log) == len(jlog) == tit
    for (tn, te, _), (jn, je, _) in zip(tlm.trial_log, jlog):
        assert abs(te - je) <= 1e-8 * je
        assert abs(tn - jn) <= 1e-8 * max(jn, 1.0)
    assert abs(tchi2 - jchi2) <= 1e-8 * jchi2


def test_cli_prints_the_same_chi2(ba_file, jax_lm, capsys):
    jchi2, jit, _ = jax_lm
    assert tmain.main(["-i", ba_file, "--device", "cpu", "-v", "-dx", ""]) == 0
    out = capsys.readouterr().out
    assert f"denormalized chi2 error: {jchi2:.2f}" in out
    assert f"solver took {jit} iterations" in out
    assert "initial denormalized chi2 error:" in out


def test_cli_without_card_fails(ba_file, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tmain.main(["-i", ba_file]) == 2
    assert "no CUDA device" in capsys.readouterr().err


#: every module of the port, all imported by the walk below
PORT_MODULES = (
    "app.ba_optimizer", "app.ba_parameter_acra", "app.block_unit", "app.dataassoc_example",
    "app.incremental_ba", "app.main", "app.plot", "app.poly_fitting", "assembly.assembler",
    "config", "evaluation.distances", "evaluation.error_eval",
    "geometry", "geometry.distortion", "geometry.minimal", "geometry.polynomial",
    "geometry.struct_average", "geometry.triangulate",
    "graph.system", "io.acceptance", "io.datasets", "io.native_parser", "io.parser",
    "linalg.block_cholesky", "linalg.block_matrix",
    "linalg.bsr", "linalg.dense", "linalg.eigen", "linalg.host_solver",
    "linalg.incremental_cholesky", "linalg.nested_schur",
    "linalg.schur", "linalg.spmv", "marginals.covariance",
    "manifolds.camera", "manifolds.se2", "manifolds.se3", "manifolds.sim3", "manifolds.so3",
    "models.ba_types", "models.rocv_types", "models.se2_types", "models.se3_types",
    "models.sim3_types", "models.types", "ops.p2c", "ops.panel", "ops.planar",
    "parallel", "parallel.collectives", "parallel.dist", "parallel.dist_cholesky",
    "parallel.multihost", "parallel.sharded_ba", "robust.losses",
    "solvers.a_solver", "solvers.dogleg", "solvers.dogleg_incremental", "solvers.fastl",
    "solvers.fastl_online", "solvers.gauss_newton", "solvers.incremental", "solvers.lm",
    "solvers.native_engine", "solvers.spcg", "utils", "utils.flops", "utils.matrix_io",
    "utils.memusage", "utils.timer")


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import slam_plus_plus_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'slam_plus_plus_tpu'))\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {PORT_MODULES!r} if 'slam_plus_plus_tpu_torch.' + m\n"
        "           not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_parallel_never_imports_jax():
    """Importing slam_plus_plus_tpu_torch.parallel alone (what a spawned
    rank does) loads neither jax nor the JAX package."""
    code = ("import sys\n"
            "import slam_plus_plus_tpu_torch.parallel\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', 'slam_plus_plus_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("kernel", ["p2c_edge_terms", "build_panels"])
def test_cuda_tensor_without_card_raises(kernel):
    """A CUDA tensor must launch the kernel or raise — never run the plain
    version.  Fake CUDA tensors stand in for a card that is absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        if kernel == "p2c_edge_terms":
            fn, E = p2c_edge_terms, 64
            args = [torch.zeros((d, E), device="cuda") for d in (11, 3, 2, 4)]
        else:
            fn = build_panels
            args = [torch.zeros((8, 4, 3, 6), device="cuda"),
                    torch.zeros((8, 4), dtype=torch.int32, device="cuda"),
                    torch.zeros((8, 9), device="cuda"), 3, 6, 5]
        before = fn.launches
        with pytest.raises(RuntimeError, match="nvcc|CUDA"):
            fn(*args)
        assert fn.launches == before
