"""Port parity for the dogleg trust-region solver (solvers/dogleg.py) and the
CLI's -dl, against the JAX package's DoglegSolver on the CPU in float64: a
small BA file (Schur backend) and a small Manhattan pose graph (dense
backend)."""

import pytest

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app import main as jmain
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.solvers.dogleg import DoglegSolver as JDL
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.solvers.dogleg import DoglegSolver as TDL


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dogleg")
    ba, pg = str(d / "ba.g2o"), str(d / "manhattan.g2o")
    jds.write_g2o_ba(ba, *jds.make_ba_scene(n_cams=8, n_points=200, seed=31))
    poses, edges = jds.make_manhattan_2d(n_poses=200, seed=3, loop_prob=0.3)
    jds.write_g2o_2d(pg, edges, poses)
    return {"ba": ba, "manhattan": pg}


@pytest.mark.parametrize("name", ["ba", "manhattan"])
def test_dogleg_matches_jax(files, name):
    jchi2, jit = JDL(jparse(files[name])).optimize(5, 0.01)
    tdl = TDL(tparse(files[name]), device="cpu")
    if name == "ba":
        assert tdl._schur is not None
    tchi2, tit = tdl.optimize(5, 0.01)
    assert tit == jit
    assert abs(tchi2 - jchi2) <= 1e-8 * jchi2


def test_cli_dogleg(files, capsys):
    assert jmain.main(["-i", files["ba"], "-nb", "-dx", "", "-dl"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(("denormalized chi2 error:", "solver took"))]
    assert len(want) == 2
    assert tmain.main(["-i", files["ba"], "--device", "cpu", "-,\\dl", "-v", "-dx", ""]) == 0
    out = capsys.readouterr().out.splitlines()
    for line in want:
        assert line in out
    assert any(ln.startswith("initial denormalized chi2 error:") for ln in out)


def test_card_dogleg_runs_float64(files, monkeypatch):
    """The dogleg's dtype policy: DoglegSolver with no dtype takes
    config.float64_dtype of its device, float64 on the card (the batch
    solvers keep float32 there); dtype=torch.float32 still gives the
    float32 dogleg."""
    import torch
    from slam_plus_plus_tpu_torch import config
    from slam_plus_plus_tpu_torch.solvers import dogleg

    assert config.float64_dtype(torch.device("cuda", 0)) == torch.float64
    assert config.default_dtype("cuda") == torch.float32
    seen = []
    monkeypatch.setattr(dogleg, "float64_dtype",
                        lambda d: seen.append(str(d)) or torch.float32)
    assert TDL(tparse(files["manhattan"]), device="cpu").asm.dtype == torch.float32
    assert seen == ["cpu"]
    monkeypatch.undo()
    f32 = TDL(tparse(files["manhattan"]), device="cpu", dtype=torch.float32)
    assert f32.asm.dtype == torch.float32
    chi2, _ = f32.optimize(5, 0.01)
    want, _ = JDL(jparse(files["manhattan"])).optimize(5, 0.01)
    assert abs(chi2 - want) <= 1e-3 * want
