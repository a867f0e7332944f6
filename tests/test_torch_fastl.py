"""The port's FastLSolver against the reference binary's goldens, float64 on
the CPU, at every solve point by the maintained factor's dirty refresh (the
replay's own capacities) or by the full redescent (capacities so small
that every walk overflows).

Goldens (tests/test_fastl.py:7-9, the reference SLAM++ `-po -nb -fL -nsp 1`
on the files the port's generators write byte for byte as the JAX
package's): chi2 to 0.01, iterations and pushes exactly.
"""

import pytest
import torch

from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg.incremental_cholesky import IncrementalCholesky
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _manhattan(tmp_path, n, seed, **kw):
    poses, edges = D.make_manhattan_2d(n_poses=n, seed=seed, **kw)
    p = str(tmp_path / f"m{n}.g2o")
    D.write_g2o_2d(p, edges, poses)
    return p


def _landmarks(tmp_path):
    _gp, _gl, pe, le = D.make_landmark_2d(n_poses=500, n_landmarks=120, world=28.0,
                                          obs_radius=6.0, seed=11)
    p = str(tmp_path / "lm.g2o")
    D.write_g2o_landmark_2d(p, pe, le)
    return p


@pytest.mark.parametrize("refresh", ["full", "dirty"])
@pytest.mark.parametrize("case, golden", [
    ("manhattan300", (46.20, 8, 0)),
    ("manhattan1500", (616.94, 206, 11)),
    ("landmarks500", (17.38, 499, 1)),
])
def test_fastl_golden(tmp_path, case, golden, refresh):
    path = {"manhattan300": lambda: _manhattan(tmp_path, 300, 91),
            "manhattan1500": lambda: _manhattan(tmp_path, 1500, 92, loop_prob=0.35),
            "landmarks500": lambda: _landmarks(tmp_path)}[case]()
    fl = FastLSolver(parse_g2o(path), device="cpu")
    if refresh == "full":
        # one dirty pair per level: every omega batch's walk overflows
        fl.inc = IncrementalCholesky(fl.chol, caps=dict(d=1, e=1, w=1, p=1))
        fl._walk_schedule()
    chi2, iters = fl.run()
    want_chi2, want_iters, want_pushes = golden
    assert fl.asm.dtype == torch.float64 and fl.asm.Nl == 0
    assert fl.refresh == "dirty"
    if refresh == "full":
        assert fl.stats["dirty_overflows"] == fl.stats["omega_steps"] > 0
    assert iters == want_iters
    assert chi2 == pytest.approx(want_chi2, abs=0.01)
    assert fl.stats["pushes"] == want_pushes
    assert fl.stats["iters"] == iters and fl.stats["solve_points"] <= iters
