"""Float32 GN on ROCV, the port against the JAX package, on the CPU.

The card's configuration (float32, one mixed class: block Cholesky + PCG)
reached on the CPU by float32 blocks and ``schur_split="off"``, on a
1,000-step ROCV scene (seed 33), whose receiver ranges reach ~400 units:

  * each range residual z - |p - t| agrees between the packages to one
    float32 ulp of the range (the residual cancels ~4 digits there);
  * the first iteration's lambda agrees to float32 rounding, and eta and
    dx differ between the packages far less than either differs from the
    float64 values (measured: eta 3.6e-4 apart, each 4.4e-3 / 4.7e-3 from
    float64; dx 8.1e-4 apart, each 0.23 from float64);
  * after 5 iterations both packages' float32 states, evaluated in float64,
    lie within 2e-6 relative of the float64 GN's chi2 2763.0785 (measured
    8.4e-7 JAX, 7.1e-7 port), while their float32 chi2 readings part by
    1.6e-5 (JAX 2763.0496, port 2763.0942): the float32 wander at the
    optimum is the float32 evaluation of the cancelling range residual, in
    both packages (ROADMAP.md Queue 3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.models.types import EDGE_TYPES as JEDGES
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
import slam_plus_plus_tpu_torch.assembly.assembler as tasm
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES as TEDGES
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver as TGN

MIXED = SolverSettings(schur_split="off")
ITERATIONS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """float64 and float32 GN of the port, float32 GN of the JAX package,
    on the same file: (path, the float64 solver, its chi2, the float32
    solvers)."""
    path = str(tmp_path_factory.mktemp("rocv_f32") / "rocv1000.g2o")
    D.write_g2o_rocv(path, *D.make_rocv_scene(n_steps=1000, seed=33))
    t64 = TGN(tparse(path), device="cpu", settings=MIXED)
    chi2_64, _ = t64.optimize(ITERATIONS)
    t32 = TGN(tparse(path), device="cpu", settings=MIXED, dtype=torch.float32)
    j32 = JGN(jparse(path), SolverConfig(dtype=jnp.float32, schur_split="off"))
    assert t32.asm.dtype == torch.float32 and t32._sparse_chol is not None
    assert j32._sparse_chol is not None and t32.asm.Nl == 0
    return path, t64, chi2_64, t32, j32


def _np(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


def _gap(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_range_residuals_agree_to_one_ulp(runs):
    _path, _t64, _c, t32, j32 = runs
    ts, js = t32.asm.snapshot_states(t32.system), j32.asm.snapshot_states(j32.system)
    td, jd = t32.asm.edge_data["edge_rocv_range"], j32.asm.edge_data["edge_rocv_range"]
    tg = (ts["pos_vel3d"][td["slot_local"][0]], ts["landmark3d"][td["slot_local"][1]])
    jg = (js["pos_vel3d"][jd["slot_local"][0]], js["landmark3d"][jd["slot_local"][1]])
    rt = _np(TEDGES["edge_rocv_range"].residual(tg, td["z"]))[:, 0]
    rj = _np(jax.vmap(JEDGES["edge_rocv_range"].residual)(jg, jd["z"]))[:, 0]
    dist = np.linalg.norm(_np(tg[0])[:, :3] - _np(tg[1]), axis=1)
    ulp = np.spacing(np.maximum(dist, np.abs(_np(td["z"])[:, 0])).astype(np.float32))
    assert dist.max() > 100.0
    assert np.all(np.abs(rt - rj) <= ulp)


def test_first_iteration_agrees_to_float32_rounding(runs):
    _path, t64, _c, t32, j32 = runs
    b64 = t64.asm.assemble(t64.asm.snapshot_states(tparse(runs[0])))
    d64, _ = t64._solve(b64)
    tb = t32.asm.assemble(t32.asm.snapshot_states(t32.system))
    jb = j32.asm.assemble(j32.asm.snapshot_states(j32.system))
    td, _ = t32._solve(tb)
    jd, _ = j32._solve(jb)
    assert _gap(tb.pp_blocks, jb.pp_blocks) <= 1e-6
    for got, want, exact in ((tb.eta_p, jb.eta_p, b64.eta_p), (td, jd, d64)):
        apart = _gap(got, want)
        assert apart <= 0.25 * min(_gap(got, exact), _gap(want, exact)), apart


def test_float32_states_lie_at_the_float64_optimum(runs):
    path, _t64, chi2_64, t32, j32 = runs
    c32, it = t32.optimize(ITERATIONS)
    jc32, jit = j32.optimize(ITERATIONS)
    assert it == jit == ITERATIONS
    assert abs(c32 - jc32) <= 1e-3 * jc32
    for system in (t32.system, j32.system):
        asm = tasm.Assembler(system, device="cpu", settings=MIXED)
        assert asm.dtype == torch.float64
        c = float(asm.chi2(asm.snapshot_states(system)))
        assert abs(c - chi2_64) <= 2e-6 * chi2_64, (c, chi2_64)
