"""The benchmark's definition: BENCHMARK.json and the files it names."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json under root, and the benchmark's files under bench_dir."""

    def __init__(self, root: str = ROOT, bench_dir: str = HERE):
        self.root, self.dir = root, bench_dir
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r}; workloads: "
                       f"{', '.join(w['name'] for w in self.data['workloads'])}")

    def config(self, name: str) -> dict:
        cfg = _json(os.path.join(self.dir, "configs", f"{name}.json"))
        if cfg.get("name") != name:
            raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
        return cfg

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        """{number: {"limit": x, ...}} that decide the cell's ``correct``."""
        return _json(os.path.join(self.dir, "limits", f"{workload}.json"))

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics this cell reports: those listing it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The ``read(ctx)`` of metrics/<metric>.py."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read
