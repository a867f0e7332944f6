"""Port parity for the two example apps (app/ba_parameter_acra.py,
app/poly_fitting.py) and the plot (app/plot.py), float64 on the CPU: the
ACRA study's rows against the JAX package's to 1e-8 relative, the fitted
coefficients to 1e-10, None from the plotting functions without
matplotlib, and the CLI's plot call unless -nb."""

import importlib.util
import os

import numpy as np
import pytest

from slam_plus_plus_tpu.app import ba_parameter_acra as jacra
from slam_plus_plus_tpu.app import plot as jplot
from slam_plus_plus_tpu.app import poly_fitting as jpoly
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu_torch.app import ba_parameter_acra as tacra
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.app import plot as tplot
from slam_plus_plus_tpu_torch.app import poly_fitting as tpoly
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse

NO_MATPLOTLIB = importlib.util.find_spec("matplotlib") is None


def test_sim3_sequence_matches_jax():
    jc, jp, jo = jacra.make_sim3_sequence(4, 30)
    tc, tp, to = tacra.make_sim3_sequence(4, 30)
    assert np.array_equal(np.asarray(tc), np.asarray(jc)) and np.array_equal(tp, jp)
    assert [(c, p) for c, p, _ in to] == [(c, p) for c, p, _ in jo]
    assert max(np.abs(a[2] - b[2]).max() for a, b in zip(to, jo)) <= 1e-10


def test_acra_rows_match_jax():
    """The JAX test's study (test_sim3_grid.py::test_acra_parameterization_study)
    through both packages, and its gates on the port's rows."""
    kw = dict(n_cams=4, n_points=30, max_iters=6, verbose=False)
    want = jacra.run_comparison(**kw)
    rows = tacra.run_comparison(device="cpu", **kw)
    assert [r["param"] for r in rows] == ["xyz", "invdepth", "invdist"]
    for g, w in zip(rows, want):
        assert (g["param"], g["n_edges"], g["iters"]) == (w["param"], w["n_edges"], w["iters"])
        for key in ("chi2_init", "chi2_final"):
            assert abs(g[key] - w[key]) <= 1e-8 * abs(w[key]), (g, w)
    assert abs(rows[0]["chi2_init"] - rows[1]["chi2_init"]) < 1e-6 * rows[0]["chi2_init"]
    assert rows[0]["chi2_final"] < rows[0]["chi2_init"] * 0.05
    assert rows[1]["chi2_final"] < rows[1]["chi2_init"] * 0.05
    assert rows[2]["chi2_final"] < 4.0 * rows[0]["chi2_final"]


def test_poly_fit_matches_jax():
    """The JAX test's quartic (test_model_families.py::test_poly_fitting_example)."""
    rng = np.random.default_rng(5)
    true_c = rng.normal(0, 1, 5)
    xs = np.linspace(-1, 1, 150)
    ys = np.polyval(true_c[::-1], xs) + rng.normal(0, 0.02, xs.shape)
    jc, jchi2 = jpoly.fit(xs, ys)
    tc, tchi2 = tpoly.fit(xs, ys, device="cpu")
    assert np.abs(tc - jc).max() <= 1e-10 * max(np.abs(jc).max(), 1.0)
    assert abs(tchi2 - jchi2) <= 1e-10 * jchi2
    assert np.abs(tc - true_c).max() < 0.05


def test_poly_fitting_main(capsys):
    assert tpoly.main(["3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    true_c, xs, ys = tpoly.demo_data(3)
    assert f"final chi2: " in out and f"over {len(xs)} samples" in out


def test_plot_system_without_matplotlib(tmp_path):
    poses, edges = jds.make_manhattan_2d(n_poses=30, seed=5)
    p = str(tmp_path / "m.g2o")
    jds.write_g2o_2d(p, edges, poses)
    got = tplot.plot_system(tparse(p), str(tmp_path / "t.png"))
    want = jplot.plot_system(jparse(p), str(tmp_path / "j.png"))
    if NO_MATPLOTLIB:
        assert got is None and want is None
    else:
        assert os.path.getsize(got) > 0 and os.path.getsize(want) > 0


@pytest.mark.parametrize("flags", [[], ["-nb"]])
def test_cli_plot_unless_nb(tmp_path, monkeypatch, capsys, flags):
    poses, edges = jds.make_manhattan_2d(n_poses=30, seed=6)
    p = str(tmp_path / "m.g2o")
    jds.write_g2o_2d(p, edges, poses)
    monkeypatch.chdir(tmp_path)
    assert tmain.main(["-i", p, "--device", "cpu", "-dx", ""] + flags) == 0
    out, err = capsys.readouterr()
    assert "warning: plot failed" not in err
    drawn = not flags and not NO_MATPLOTLIB
    assert ("plot written to solution.png" in out) == drawn
    assert os.path.exists(tmp_path / "solution.png") == drawn
