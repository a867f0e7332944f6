"""A copy of the benchmark's definition at test size, in a temporary
directory: the same cells, traffic, limits and readers, each configuration's
scene cut to its own ``test_params`` and each traffic file's
``test_overrides`` applied."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.spec import ROOT, Spec

SEED = 3000000019     # past 32 signed bits, as a run's seed may be


def _test_params(cfg: dict) -> None:
    if "test_params" not in cfg:
        raise KeyError(f"configuration {cfg.get('name')!r} states no test_params: "
                       f"its scene would run at full size in the CPU tests")
    cfg["scene"]["params"].update(cfg["test_params"])


def _test_overrides(traffic: dict) -> None:
    traffic.update(traffic.get("test_overrides", {}))


def force_block_cholesky(monkeypatch) -> None:
    """Batch GN takes the pose graph's block Cholesky at any size, as a
    full-size pose graph does (past the dense factor's limit): the test
    size alone would take the dense factor."""
    from slam_plus_plus_tpu_torch.solvers import gauss_newton

    monkeypatch.setattr(gauss_newton, "DENSE_LIMIT", 0)


def small_spec(tmp, root: str = ROOT) -> Spec:
    """root's BENCHMARK.json and benchmark/ definition, copied to tmp at
    test size."""
    tmp = str(tmp)
    bench = os.path.join(tmp, "benchmark")
    os.makedirs(tmp, exist_ok=True)
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp)
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(root, "benchmark", d), os.path.join(bench, d))
    for d, cut in (("configs", _test_params), ("traffic", _test_overrides)):
        for name in os.listdir(os.path.join(bench, d)):
            path = os.path.join(bench, d, name)
            with open(path) as f:
                data = json.load(f)
            cut(data)
            with open(path, "w") as f:
                json.dump(data, f)
    return Spec(tmp, bench)
