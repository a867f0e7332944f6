"""The C++ replay engine under the port's FastL (solvers/native_engine.py),
on the CPU in float64.

- The reference binary's FastL goldens (tests/test_fastl.py:7-9): chi2 to
  0.01, iterations and pushes exactly.
- The JAX package's FastLSolver with its default native engine runs the
  same C++ over the same plan: equal iterations and pushes, chi2 within
  1e-12 relative and the final states within 1e-12 x scale, in FastL and
  in lambda mode.
- The port's torch engine: equal iterations and pushes, chi2 within 1e-6
  relative (the bound of tests/test_fastl.py:185-222), in both modes.
- The replays the engine does not serve raise, naming the reason; the
  CLI's --device cpu --native prints the torch engine's lines, and its
  errors return 1.
"""

import re

import numpy as np
import pytest
import torch

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.solvers.fastl import FastLSolver as JFastL
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
from slam_plus_plus_tpu_torch.solvers.incremental import IncrementalSolver
from slam_plus_plus_tpu_torch.solvers.native_engine import UnsupportedReplay

GOLDENS = {"manhattan300": (46.20, 8, 0), "manhattan1500": (616.94, 206, 11),
           "landmarks500": (17.38, 499, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_engine")
    out = {name: str(d / f"{name}.g2o") for name in
           ("manhattan300", "manhattan1500", "landmarks500", "m300_92", "landmarks150",
            "sphere40")}
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=91)
    D.write_g2o_2d(out["manhattan300"], edges, poses)
    poses, edges = D.make_manhattan_2d(n_poses=1500, seed=92, loop_prob=0.35)
    D.write_g2o_2d(out["manhattan1500"], edges, poses)
    _gp, _gl, pe, le = D.make_landmark_2d(n_poses=500, n_landmarks=120, world=28.0,
                                          obs_radius=6.0, seed=11)
    D.write_g2o_landmark_2d(out["landmarks500"], pe, le)
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=92, loop_prob=0.3)
    D.write_g2o_2d(out["m300_92"], edges, poses)
    _gp, _gl, pe, le = D.make_landmark_2d(n_poses=150, n_landmarks=60, seed=3)
    D.write_g2o_landmark_2d(out["landmarks150"], pe, le)
    poses, edges = D.make_sphere_3d(n_poses=40, seed=11)
    D.write_g2o_3d(out["sphere40"], edges, poses)
    return out


@pytest.mark.parametrize("case", GOLDENS)
def test_goldens(files, case):
    fl = FastLSolver(parse_g2o(files[case]), device="cpu", native=True)
    assert fl.inc is None and fl._native is not None
    chi2, iters = fl.run()
    want_chi2, want_iters, want_pushes = GOLDENS[case]
    assert iters == want_iters
    assert chi2 == pytest.approx(want_chi2, abs=0.01)
    assert fl.stats["pushes"] == want_pushes
    assert fl.stats["iters"] == iters and fl.stats["solve_points"] <= iters


def _states(system):
    return {t: s.data.copy() for t, s in system.vertex_stores.items()}


@pytest.mark.parametrize("onetime_dx", [True, False], ids=["fastl", "lambda"])
@pytest.mark.parametrize("case", GOLDENS)
def test_matches_jax_native_engine(files, case, onetime_dx):
    jsys = jparse(files[case])
    jfl = JFastL(jsys, every_n=1, onetime_dx=onetime_dx)
    assert jfl._native is not None, "the JAX package did not take its native engine"
    jchi2, jiters = jfl.run()
    fl = FastLSolver(parse_g2o(files[case]), device="cpu", native=True, onetime_dx=onetime_dx)
    chi2, iters = fl.run()
    assert iters == jiters
    assert fl.stats["pushes"] == jfl.stats["pushes"]
    assert fl.stats["full_refactors"] == jfl.stats["full_refactors"]
    assert abs(chi2 - jchi2) <= 1e-12 * jchi2
    for t, want in _states(jsys).items():
        got = fl.system.vertex_stores[t].data
        assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0), t


@pytest.mark.parametrize("mode", ["fastl", "lambda"])
@pytest.mark.parametrize("case", ["m300_92", "landmarks150"])
def test_matches_torch_engine(files, case, mode):
    def run(native):
        system = parse_g2o(files[case])
        if mode == "fastl":
            s = FastLSolver(system, device="cpu", native=native)
        else:
            s = IncrementalSolver(system, device="cpu", native=native)
            s = s._delegate
        chi2, iters = s.run()
        return chi2, iters, s.stats["pushes"]

    (chi2, iters, pushes), (tchi2, titers, tpushes) = run(True), run(False)
    assert (iters, pushes) == (titers, tpushes)
    assert pushes > 0
    assert abs(chi2 - tchi2) <= 1e-6 * max(abs(tchi2), 1.0)


@pytest.mark.parametrize("case, kw, reason", [
    ("sphere40", {}, "SE\\(2\\) and 2D-landmark graphs; this one has pose3d, edge_pose3d"),
    ("m300_92", {"marginals": True}, "no in-loop marginals"),
    ("m300_92", {"device": "cuda"}, "on the host: device 'cuda'"),
], ids=["se3", "marginals", "cuda"])
def test_unsupported_replays_raise(files, case, kw, reason):
    kw = {"device": "cpu", **kw}
    with pytest.raises(UnsupportedReplay, match=reason):
        FastLSolver(parse_g2o(files[case]), native=True, **kw)


def test_lambda_mode_own_path_raises(files):
    with pytest.raises(UnsupportedReplay, match="maintained-factor replay only"):
        IncrementalSolver(parse_g2o(files["m300_92"]), device="cpu", native=True,
                          on_step=lambda *a: None)


def _lines(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("solver took", "denormalized chi2 error:"))]


@pytest.mark.parametrize("flags", [["-nsp", "1", "-fL"], ["-nsp", "1"]], ids=["fastl", "lambda"])
def test_cli_native_prints_the_torch_engines_lines(files, capsys, flags):
    argv = ["-i", files["m300_92"], "-po", "--device", "cpu", "-dx", ""] + flags
    assert tmain.main(argv) == 0
    want = _lines(capsys.readouterr().out)
    assert len(want) == 2
    assert tmain.main(argv + ["--native"]) == 0
    assert _lines(capsys.readouterr().out) == want


@pytest.mark.parametrize("case, flags, message", [
    ("m300_92", ["-nsp", "1", "--device", "cuda"], "--native runs the C\\+\\+ replay engine"),
    ("m300_92", ["--device", "cpu"], "--native serves the incremental solvers"),
    ("sphere40", ["-nsp", "1", "-fL", "--device", "cpu"], "SE\\(2\\) and 2D-landmark"),
], ids=["cuda", "batch", "se3"])
def test_cli_native_errors(files, capsys, case, flags, message):
    assert tmain.main(["-i", files[case], "-dx", "", "--native"] + flags) == 1
    assert re.search(message, capsys.readouterr().err)
