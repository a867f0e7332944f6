"""The harness on the CPU: every cell's traffic at test size, the look for
a card, the modules a run loads, and a definition found by name."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.spec import HERE, ROOT, Spec
from benchmark.tests.small import SEED, force_block_cholesky, small_spec

CELLS = [w["name"] for w in Spec().data["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_cpu(tmp_path, cell, trace):
    spec = small_spec(tmp_path)
    r = run.run_cell(spec, cell, SEED, 0.2, trace, "cpu")
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in (spec.per_layer(cell) if trace else spec.end_to_end(cell))}
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert "construct_s" in r["metrics"]


def test_run_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "CUDA device" in proc.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone runs no cell."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


_MODULES = """
import sys
{body}
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def _top_modules(body: str, cwd) -> list:
    proc = subprocess.run([sys.executable, "-c", _MODULES.format(body=body)], cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return eval(proc.stdout.strip().splitlines()[-1])


def test_a_cell_loads_no_jax(tmp_path):
    body = (f"from benchmark import run\nfrom benchmark.tests.small import small_spec\n"
            f"spec = small_spec({str(tmp_path)!r})\n"
            + "".join(f"run.run_cell(spec, {c!r}, 5, 0.1, True, 'cpu')\n" for c in CELLS))
    mods = _top_modules(body, ROOT)
    assert "slam_plus_plus_tpu_torch" in mods
    assert not {"jax", "jaxlib", "flax", "slam_plus_plus_tpu"} & set(mods)


def test_the_reference_loads_nothing_of_the_program():
    refs = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "reference"))
                  if f.endswith(".py"))
    body = "".join(f"import benchmark.reference.{m}\n" for m in refs)
    mods = _top_modules(body, ROOT)
    assert not {"jax", "jaxlib", "flax", "slam_plus_plus_tpu",
                "slam_plus_plus_tpu_torch"} & set(mods)


def test_definitions_found_by_name(tmp_path):
    spec = small_spec(tmp_path)
    cfg = spec.config("pose-manhattan3500")
    cfg["name"] = "pose-new"
    with open(os.path.join(spec.dir, "configs", "pose-new.json"), "w") as f:
        json.dump(cfg, f)
    assert spec.config("pose-new")["scene"] == cfg["scene"]
    with pytest.raises(FileNotFoundError):
        spec.config("pose-absent")
    for m in spec.data["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in spec.data["workloads"]:
        spec.traffic(w["traffic"])
        assert set(spec.limits(w["name"]))


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "slam_plus_plus_tpu_torch_probe", type(sys)("probe"))
    monkeypatch.setitem(sys.modules, "slam_plus_plus_tpu_torch_probe.sub", type(sys)("sub"))
    assert "slam_plus_plus_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", type(sys)("numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_replay_marks_its_part(tmp_path):
    """A replay's profiled part runs between one begin and one end, over
    the poses its share of the stream feeds."""
    from benchmark import drivers, scenes
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast

    spec = small_spec(tmp_path)
    w = spec.workload("manhattan3500.fastl")
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    scene = scenes.generate(cfg, SEED)
    system = parse_g2o_fast(scenes.scene_file(cfg, scene, SEED, run.CACHE))
    d = drivers.build(system, scene, cfg, traffic, "cpu")
    a, b = d.part_steps
    assert (a, b) == tuple(round(f * scene.n_edges) for f in traffic["profile_part"])
    new = [len(s["new_vs"]) for s in d.solver.steps]
    assert d.part_work == sum(new[a:b]) > 0
    calls = []
    d.unit((lambda: calls.append("begin"), lambda: calls.append("end")))
    assert calls == ["begin", "end"]
    assert d.solver.steps is not None and type(d.solver.steps) is list


def test_a_new_configuration_runs_at_its_own_test_size(tmp_path):
    """A configuration that nothing but its own file knows is cut to its
    ``test_params`` in every CPU test; one that states none is refused."""
    root = tmp_path / "root"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = Spec().config("pose-manhattan3500")
    cfg.update(name="pose-new", test_params=dict(n_poses=150, closures=15))
    with open(root / "benchmark" / "configs" / "pose-new.json", "w") as f:
        json.dump(cfg, f)
    bench["workloads"].append(dict(name="new.batch", config="pose-new", traffic="gn_batch",
                                   chips=1, why="a configuration added by its files alone"))
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    shutil.copy(root / "benchmark" / "limits" / "manhattan3500.batch.json",
                root / "benchmark" / "limits" / "new.batch.json")
    spec = small_spec(tmp_path / "small", root=str(root))
    assert spec.config("pose-new")["scene"]["params"]["n_poses"] == 150
    r = run.run_cell(spec, "new.batch", SEED, 0.0, False, "cpu", keep_reference=True)
    assert r["correct"]
    assert r["_"]["scene"].n_poses == 150 and len(r["_"]["answer"]["pose2d"]) == 150
    del cfg["test_params"]
    with open(root / "benchmark" / "configs" / "pose-new.json", "w") as f:
        json.dump(cfg, f)
    with pytest.raises(KeyError, match="test_params"):
        small_spec(tmp_path / "again", root=str(root))


def test_gn_batch_routes_to_the_block_cholesky_at_full_size(tmp_path):
    """At the configuration's 3,500 poses (10,500 dims, past the dense
    factor's 6,000) the batch GN takes the block Cholesky and no dense
    factor; the test size, under the limit, takes the dense one.  Built,
    not solved."""
    from benchmark import drivers, scenes
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast

    spec = Spec()
    traffic = spec.traffic("gn_batch")
    for cfg, want in ((spec.config("pose-manhattan3500"), "_sparse_chol"),
                      (small_spec(tmp_path).config("pose-manhattan3500"), "_dense")):
        scene = scenes.generate(cfg, SEED)
        system = parse_g2o_fast(scenes.scene_file(cfg, scene, SEED, run.CACHE))
        d = drivers.build(system, scene, cfg, traffic, "cpu")
        taken = [n for n in ("_schur", "_sparse_chol", "_dense", "_host")
                 if getattr(d.solver, n) is not None]
        assert taken == [want], (cfg["scene"]["params"]["n_poses"], d.route())
        assert d.solver.asm.dtype == drivers.expected_dtype(cfg, "cpu")
        assert f"linear solver {want}" in d.route()


@pytest.mark.parametrize("trace", [False, True])
def test_gn_batch_on_the_block_cholesky_at_test_size(tmp_path, monkeypatch, capsys, trace):
    """The GN cell on its full-size route, the block Cholesky, at test size:
    the reference agrees to rounding, and a traced run reads the factor's
    and the assembly's spans."""
    force_block_cholesky(monkeypatch)
    spec = small_spec(tmp_path)
    r = run.run_cell(spec, "manhattan3500.batch", SEED, 0.2, trace, "cpu")
    assert "linear solver _sparse_chol," in capsys.readouterr().err
    assert r["correct"] and r["failed"] == 0
    for name, c in r["checks"].items():
        assert c["value"] <= 1e-6, (name, c)
    if trace:
        assert {"factor_ms.gn", "assemble_ms.gn", "construct_s"} <= set(r["metrics"])
        assert all(r["metrics"][m]["value"] > 0 for m in ("factor_ms.gn", "assemble_ms.gn"))
    else:
        assert r["metrics"]["solve_ms.gn"]["value"] > 0
