"""Whole incremental replays, back to back: restore the parsed initial
estimate and run ``FastLSolver.run()`` of the solver built in set-up, which
feeds the stream edge by edge and solves at every solve point.  The warm-up
replays a short prefix of the same stream on a solver of its own, read from
a g2o file of its own by the program's parser, as the whole stream is.

The profiled part of a replay is the traffic's ``profile_part`` [a, b), as
shares of the stream's edges: the replay plan the solver walks
(``FastLSolver.steps``, one entry per edge) is handed to it marked, so that
the part's begin and end run as the walk reaches edge a and edge b.  A
whole replay under the profiler's device tracing runs 1.6x as long and
takes minutes to read back."""

from __future__ import annotations

import os
import tempfile

from benchmark import drivers


class ReplayDriver:
    def __init__(self, system, scene, config, traffic, device):
        from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

        if traffic["solver"] != "fastl":
            raise ValueError(f"replay driver: no solver {traffic['solver']!r}")
        self.kw = dict(every_n=int(traffic["every_n"]),
                       max_iterations=int(traffic["max_iterations"]),
                       dx_threshold=float(traffic["dx_threshold"]))
        self.system, self.scene, self.device = system, scene, device
        self.warm_poses = int(traffic["warm_up_poses"])
        self.solver = FastLSolver(system, device=device, **self.kw)
        want = drivers.expected_dtype(config, device)
        if self.solver.asm.dtype != want:
            raise RuntimeError(f"the program replays in {self.solver.asm.dtype}; the "
                               f"configuration states {want}")
        self.initial = drivers.snapshot(system)
        self.construct_s = self.solver.timing["construct"]
        self.work_per_unit = scene.n_poses
        a, b = (round(f * len(self.solver.steps)) for f in traffic["profile_part"])
        self.part_steps = (a, b)
        active = [0] + [s["n_active"] for s in self.solver.steps]
        self.part_work = active[b] - active[a]      # poses fed in [a, b)
        self.chi2 = float("nan")

    def route(self) -> str:
        return f"{self.solver.asm.dtype}, FastL over {len(self.solver.steps)} edges"

    def warm_up(self):
        from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast
        from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "prefix.g2o")
            self.scene.prefix(self.warm_poses).write(path)
            g = parse_g2o_fast(path)
        FastLSolver(g, device=self.device, **self.kw).run()

    def unit(self, part=None) -> float:
        drivers.restore(self.system, self.initial)
        steps = self.solver.steps
        marked = _Marked(steps, *self.part_steps, *part) if part else None
        if marked is not None:
            self.solver.steps = marked
        try:
            self.chi2, _ = self.solver.run()
        finally:
            self.solver.steps = steps
        if marked is not None and marked.fired != 2:
            raise RuntimeError("the replay did not walk FastLSolver.steps once; its "
                               "profiled part cannot be marked")
        return self.chi2

    def answer(self) -> dict:
        return {**drivers.by_id(self.system), "chi2": self.chi2}

    def layers(self) -> dict:
        return {}

    def counts(self) -> dict:
        return {"poses": self.scene.n_poses, "edges": self.scene.n_edges,
                **{k: self.solver.stats.get(k) for k in ("solve_points", "pushes")}}


class _Marked(list):
    """A replay plan whose walk calls begin() as it reaches entry a and
    end() as it reaches entry b (or its end)."""

    def __init__(self, steps, a, b, begin, end):
        super().__init__(steps)
        self.a, self.b, self.begin, self.end = a, b, begin, end
        self.fired = 0

    def __iter__(self):
        for k, step in enumerate(list.__iter__(self)):
            if k == self.a:
                self.begin()
                self.fired += 1
            if k == self.b:
                self.end()
                self.fired += 1
            yield step
        if self.b >= len(self):
            self.end()
            self.fired += 1


def build(system, scene, config, traffic, device):
    return ReplayDriver(system, scene, config, traffic, device)
