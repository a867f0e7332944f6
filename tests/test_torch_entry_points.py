"""The port's run entry points, on the CPU at small sizes, against the JAX
package's: the bench module's step (bench.py's, whose step is a closure
inside ``_bench``, built here from the JAX modules as
tests/test_torch_slice.py builds it), the bench's result line, the
acceptance runner (a row, its JSON line and summary, the exit code on a
miss) and the Schur-orderings CLI against scripts/schur_orderings.py.  The
three new modules import nothing of JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.schur import SchurSolver as JSchur
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
from slam_plus_plus_tpu.solvers.lm import damp_system as jdamp
from slam_plus_plus_tpu_torch import bench
from slam_plus_plus_tpu_torch.app import acceptance, schur_orderings
from slam_plus_plus_tpu_torch.io import acceptance as goldens
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0)


@pytest.fixture(scope="module")
def ba_file(tmp_path_factory):
    """tests/test_torch_slice.py's small BA file."""
    cams, pts, obs = jds.make_ba_scene(n_cams=8, n_points=200, seed=31)
    p = str(tmp_path_factory.mktemp("bench") / "ba.g2o")
    jds.write_g2o_ba(p, cams, pts, obs)
    return p


def test_bench_step_matches_jax(ba_file):
    """Two of the bench module's steps against bench.py's (assemble, damp
    by 1e-3 max_hdiag, the dense Schur solve, update), from the same
    states: chi2 and the states after each step."""
    js = jparse(ba_file)
    ja = JAssembler(js)
    jsch = JSchur(ja)
    step, tst = bench.bench_step(tparse(ba_file), "cpu")
    assert step.schur.uniform and step.asm.pl_uniform is not None
    jst = ja.snapshot_states(js)
    for t in jst:
        assert _rel(tst[t].numpy(), jst[t]) == 0.0
    for _ in range(2):
        sums = ja._edge_sums(jst, ja.edge_data)
        jb = ja._finalize(*sums)
        jb = jdamp(jb, jb.max_hdiag * jnp.asarray(1e-3, dtype=ja.dtype), ja.pp_diag_ids_dev)
        jst = ja._update_impl(jst, *jsch._solve_dense_impl(jb))
        tst, tchi2 = step(tst)
        assert abs(float(tchi2) - float(jb.chi2)) <= 1e-9 * float(jb.chi2)
        for t in jst:
            assert _rel(tst[t].numpy(), jst[t]) <= 1e-9, t


@pytest.fixture
def small_rows(tmp_path, monkeypatch):
    """The acceptance files and the bench scene at small sizes in a
    scratch build directory: manhattan3500 is a 300-pose manhattan (seed
    91); returns its path."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    path = str(tmp_path / "m300.g2o")
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=91)
    D.write_g2o_2d(path, edges, poses)

    def dataset(name, directory):
        assert name == "manhattan3500", name
        return path

    monkeypatch.setattr(goldens, "dataset", dataset)
    return path


def test_bench_prints_its_metric_line(small_rows, monkeypatch, capsys):
    """The bench entry point on --device cpu at 8 cameras / 200 points, the
    C++ engine's extra on the 300-pose file: exit 0 and a last line with
    bench.py's keys; without a card --device cuda fails with exit 2."""
    monkeypatch.setattr(bench, "N_CAMS", 8)
    monkeypatch.setattr(bench, "N_POINTS", 200)
    assert bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "ba_solve_iter" and out["unit"] == "ms"
    assert out["value"] > 0 and out["vs_baseline"] == pytest.approx(
        bench.REF_MS_PER_ITER / out["value"], rel=1e-2)
    assert out["fastl_native"] and out["fastl_m3500_chi2"] > 0
    assert {"fastl_m3500_wall_s", "fastl_m3500_ms_per_applied_step"} <= set(out)
    assert set(out["breakdown_s"]) == {"kernel_build", "scene_parse", "plan", "first_step"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2


def test_acceptance_row_passes_then_misses(small_rows, monkeypatch, capsys):
    """manhattan3500's batch row on the 300-pose file, its golden the JAX
    package's GN chi2 on the same file: the row's JSON line and a passing
    summary; with the golden lowered, the summary counts the miss and
    main() returns 1."""
    jchi2, _ = JGN(jparse(small_rows)).optimize(5, 0.01)
    monkeypatch.setitem(goldens.ROWS, "manhattan3500", (["-po"], jchi2))
    assert acceptance.main(["--device", "cpu", "--rows", "manhattan3500 batch"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row, summary = json.loads(lines[-2]), json.loads(lines[-1])
    assert summary == {"passed": 1, "total": 1}
    assert row["row"] == "manhattan3500 batch -po" and row["passed"]
    assert abs(row["chi2"] - jchi2) <= 1e-8 * jchi2
    assert row["dtype"] == "float64" and row["device"] == "cpu"
    assert row["iterations"] > 0 and row["ms_per_iteration"] > 0

    monkeypatch.setitem(goldens.ROWS, "manhattan3500", (["-po"], jchi2 / 2))
    assert acceptance.main(["--device", "cpu", "--rows", "manhattan3500 batch"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"passed": 0, "total": 1}
    assert not json.loads(lines[-2])["passed"]


def test_acceptance_rows_are_the_jax_scripts():
    """The runner's rows: scripts/acceptance.py's fifteen, its quick ones
    quick, each with a golden."""
    assert len(acceptance.ROWS) == 15
    assert sum(q for *_r, q in acceptance.ROWS) == 7
    for name, ds, kind, _q in acceptance.ROWS:
        assert (ds in goldens.INCREMENTAL_ROWS) if kind == "incremental" else (ds in goldens.ROWS)


def test_schur_orderings_prints_the_jax_scripts_lines(tmp_path, capsys):
    """The port's CLI and scripts/schur_orderings.py on manhattan 300: the
    same levels, bottom, flop model and nested-Schur rows, line for line."""
    path = str(tmp_path / "m300.g2o")
    poses, edges = D.make_manhattan_2d(n_poses=300, seed=91)
    D.write_g2o_2d(path, edges, poses)
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "schur_orderings.py"),
                          path], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert schur_orderings.main([path, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got == res.stdout.strip().splitlines()
    assert sum(line.lstrip().startswith("L") for line in got) >= 3


def test_entry_points_import_no_jax():
    code = ("import sys\n"
            "import slam_plus_plus_tpu_torch.bench, slam_plus_plus_tpu_torch.app.acceptance\n"
            "import slam_plus_plus_tpu_torch.app.schur_orderings\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', 'slam_plus_plus_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
