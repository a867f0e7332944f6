"""A copy of the benchmark's definition at test size, in a temporary
directory: the same cells, traffic, limits and readers, the scenes cut."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.spec import HERE, ROOT, Spec

#: scene parameters at test size, per configuration
SMALL = {
    "ba-ring871": dict(n_cams=24, n_points=400, obs_per_point=4),
    "pose-manhattan3500": dict(n_poses=300, closures=167),
}
SEED = 3000000019     # past 32 signed bits, as a run's seed may be


def small_spec(tmp) -> Spec:
    tmp = str(tmp)
    bench = os.path.join(tmp, "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(bench, d))
    for name, params in SMALL.items():
        path = os.path.join(bench, "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["scene"]["params"].update(params)
        with open(path, "w") as f:
            json.dump(cfg, f)
    path = os.path.join(bench, "traffic", "fastl_replay.json")
    with open(path) as f:
        traffic = json.load(f)
    traffic["warm_up_poses"] = 40
    with open(path, "w") as f:
        json.dump(traffic, f)
    return Spec(tmp, bench)
