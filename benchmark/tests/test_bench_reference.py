"""The plain references against the port's float64 CPU result at test size,
and the controls: the reference in the next lower precision than the
configuration states, put in the program's place, fails the cell's
limits."""

from __future__ import annotations

import importlib
import json
import os

import pytest

from benchmark import run
from benchmark.reference.precision import PRECISIONS, round_tf32
from benchmark.spec import Spec
from benchmark.tests.small import SEED, small_spec

CELLS = [w["name"] for w in Spec().data["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, 11])
def test_reference_agrees_with_the_port(tmp_path, cell, seed):
    r = run.run_cell(small_spec(tmp_path), cell, seed, 0.0, False, "cpu")
    assert r["correct"]
    # float64 on both sides: the gaps of rounding alone
    for name, c in r["checks"].items():
        assert c["value"] <= 1e-6, (name, c)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tmp_path, cell):
    spec = small_spec(tmp_path)
    r = run.run_cell(spec, cell, SEED, 0.0, False, "cpu", keep_reference=True)
    keep = r.pop("_")
    cfg, ref_mod = keep["cfg"], keep["ref_mod"]
    ctl = ref_mod.solve(keep["scene"].as_read(), keep["traffic"],
                        PRECISIONS[cfg["control"]], "cpu")
    numbers = ref_mod.compare(ref_mod.as_answer(ctl), keep["ref"])
    limits = spec.limits(cell)
    assert any(v > limits[k]["limit"] for k, v in numbers.items()), numbers


def test_tf32_rounding():
    import torch

    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0 - 2.0 ** -12],
                     dtype=torch.float32)
    # 10 mantissa bits: the halfway cases go to even
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 4 * 2.0 ** -11, -3.0]


def test_reference_modules_have_the_entry_points():
    """Every reference that a configuration or a traffic file names, and
    the one each cell runs."""
    spec = Spec()
    named = set()
    for d in ("configs", "traffic"):
        for f in os.listdir(os.path.join(spec.dir, d)):
            with open(os.path.join(spec.dir, d, f)) as fh:
                data = json.load(fh)
            if "reference" in data:
                named.add(data["reference"])
    for w in spec.data["workloads"]:
        want = spec.traffic(w["traffic"]).get("reference", spec.config(w["config"])["reference"])
        assert want in named
    assert {"ba_lm", "pose_fastl", "pose_gn"} <= named
    for ref in named:
        mod = importlib.import_module(f"benchmark.reference.{ref}")
        for fn in ("solve", "compare", "as_answer"):
            assert callable(getattr(mod, fn))
