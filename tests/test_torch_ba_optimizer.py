"""The port's BA facade (app/ba_optimizer.py) against the JAX package's, and
its C API (csrc/ba_c_api.cpp) driven by the unchanged native/ba_c_test.c,
on the CPU in float64.

The facades are fed the scene of tests/test_solvers.py:105 one call at a
time.  chi2 before and after LM's 5 iterations within 1e-9 relative and the
same iteration count; the states within 1e-9 x scale; the dumps equal
byte for byte.  covariances() at the gauge jitter 1e-10 within 1e-6 x
scale: mono BA's Sigma holds the scale gauge's eigenvalue as a difference
of far larger terms, so two float64 Schur recoveries of it differ far
above rounding (1.2e-8 measured on this scene; tests/test_torch_marginals.py
holds such scenes at 1e-3 from the true Sigma).
"""

import os
import subprocess

import numpy as np
import pytest

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app.ba_optimizer import BAOptimizer as JBAOptimizer
from slam_plus_plus_tpu_torch.app.ba_optimizer import BAOptimizer
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _feed(opt):
    cams, pts, obs = D.make_ba_scene(n_cams=8, n_points=120, seed=18)
    rng = np.random.default_rng(5)
    for c, (pos, q, fx, fy, cx, cy, d) in enumerate(cams):
        opt.add_cam_vertex_g2o(c, pos, q, fx, fy, cx, cy, d)
    for p, pt in enumerate(pts):
        opt.add_xyz_vertex(len(cams) + p, pt + rng.normal(0, 0.05, 3))
    for (pid, cid, u, v) in obs:
        opt.add_p2c_edge(len(cams) + pid, cid, [u, v], np.eye(2))
    return opt


@pytest.fixture(scope="module")
def facades():
    return _feed(JBAOptimizer()), _feed(BAOptimizer(device="cpu"))


def test_feeding_and_chi2(facades):
    j, t = facades
    assert (t.n_vertices(), t.n_edges()) == (j.n_vertices(), j.n_edges())
    assert t.system.vertex_order == j.system.vertex_order
    for g in j.system.vertex_order:
        assert np.array_equal(t.vertex_state(g), j.vertex_state(g))
    assert abs(t.chi2() - j.chi2()) <= 1e-9 * j.chi2()


def test_lm_matches_jax():
    j, t = _feed(JBAOptimizer()), _feed(BAOptimizer(device="cpu"))
    (jchi2, jit), (tchi2, tit) = j.optimize(5), t.optimize(5)
    assert tit == jit
    assert abs(tchi2 - jchi2) <= 1e-9 * jchi2
    for g in j.system.vertex_order:
        want = j.vertex_state(g)
        assert np.abs(t.vertex_state(g) - want).max() <= 1e-9 * max(np.abs(want).max(), 1.0)


def test_dumps_and_covariances_match_jax(facades, tmp_path):
    j, t = facades
    j.optimize(5)
    t.optimize(5)
    for name in ("dump_state", "dump_graph"):
        getattr(j, name)(str(tmp_path / f"jax_{name}.txt"))
        getattr(t, name)(str(tmp_path / f"port_{name}.txt"))
        assert ((tmp_path / f"port_{name}.txt").read_text() ==
                (tmp_path / f"jax_{name}.txt").read_text()), name
    cj, ct = j.covariances(), t.covariances()
    for f in ("p_diag", "l_diag"):
        want, got = np.asarray(getattr(cj, f)), getattr(ct, f).cpu().numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), f


def _run_c_test(tmp_path, device):
    """Build the port's C API, link native/ba_c_test.c against it and run
    it with SLAMPP_DEVICE=device; a poisoned jax package first on the
    interpreter's path records any import of jax."""
    lib, _secs = _build.build_host("ba_c_api")
    exe = str(tmp_path / "ba_c_test")
    cc = subprocess.run(["gcc", "-O2", os.path.join(REPO, "native", "ba_c_test.c"), "-o", exe,
                         lib, f"-Wl,-rpath,{os.path.dirname(lib)}"],
                        capture_output=True, text=True)
    assert cc.returncode == 0, cc.stderr
    poison = tmp_path / "poison" / "jax"
    poison.mkdir(parents=True)
    marker = tmp_path / "jax_was_imported"
    (poison / "__init__.py").write_text(
        f"open({str(marker)!r}, 'w').close()\nraise ImportError('jax must not be imported')\n")
    env = {**os.environ, "SLAMPP_ROOT": REPO, "SLAMPP_DEVICE": device,
           "PYTHONPATH": str(poison.parent)}
    run = subprocess.run([exe], capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(tmp_path))
    return run, marker.exists()


def test_c_api_on_the_cpu_never_imports_jax(tmp_path):
    run, jax_imported = _run_c_test(tmp_path, "cpu")
    assert run.returncode == 0, run.stdout + run.stderr
    assert "C API OK" in run.stdout
    assert not jax_imported


def test_c_api_failure_is_printed_and_returned(tmp_path):
    """A Python exception in a call (here an unknown device) is printed,
    and the call returns its failure value: ba_c_test.c exits 1."""
    run, jax_imported = _run_c_test(tmp_path, "no-such-device")
    assert run.returncode == 1
    assert "create failed" in run.stderr and "Traceback" in run.stderr
    assert not jax_imported
