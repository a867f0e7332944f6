"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped (the CPU), everything else as a run does
it, one planted fault at a time, in every cell, by its traffic's driver."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.spec import Spec
from benchmark.tests.small import SEED, force_block_cholesky, small_spec


def _unchanged(monkeypatch):
    """A solve or replay that leaves the states where they started."""
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
    from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

    for cls in (LevenbergMarquardtSolver, GaussNewtonSolver):
        monkeypatch.setattr(cls, "optimize", lambda self, *a, **k: (self.chi2(), 0))
    monkeypatch.setattr(FastLSolver, "run", lambda self, *a, **k: (1.0, 0))


def _altered(monkeypatch):
    """One state of the answer altered where it is produced."""
    from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver
    from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
    from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

    def wrap(cls, name):
        inner = getattr(cls, name)

        def altered(self, *a, **k):
            out = inner(self, *a, **k)
            store = next(iter(self.system.vertex_stores.values()))
            store.states[store.n - 1, 0] += 0.05
            return out

        monkeypatch.setattr(cls, name, altered)

    wrap(LevenbergMarquardtSolver, "optimize")
    wrap(GaussNewtonSolver, "optimize")
    wrap(FastLSolver, "run")


def _half_the_observations(monkeypatch):
    """A batch solve's normal equations built from every other observation
    or edge."""
    from benchmark.drivers import batch

    inner = batch.BatchDriver.__init__

    def init(self, *a, **k):
        inner(self, *a, **k)
        for data in self.solver.asm.edge_data.values():
            for key in ("info", "info_t"):
                if key in data:
                    x = data[key]
                    (x[..., ::2] if key == "info_t" else x[::2]).zero_()

    monkeypatch.setattr(batch.BatchDriver, "__init__", init)


#: the faults a cell can have, by its traffic's driver
FAULTS = {"batch": (_unchanged, _altered, _half_the_observations),
          "replay": (_unchanged, _altered)}
SPEC = Spec()


@pytest.mark.parametrize("cell,fault", [
    (w["name"], fault) for w in SPEC.data["workloads"]
    for fault in FAULTS[SPEC.traffic(w["traffic"])["driver"]]])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    spec = small_spec(tmp_path)
    assert run.run_cell(spec, cell, SEED, 0.0, False, "cpu")["correct"]
    fault(monkeypatch)
    r = run.run_cell(spec, cell, SEED, 0.0, False, "cpu")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS["batch"])
def test_fault_on_the_block_cholesky_route(tmp_path, monkeypatch, fault):
    """The GN cell at test size on its full-size route."""
    force_block_cholesky(monkeypatch)
    spec = small_spec(tmp_path)
    assert run.run_cell(spec, "manhattan3500.batch", SEED, 0.0, False, "cpu")["correct"]
    fault(monkeypatch)
    r = run.run_cell(spec, "manhattan3500.batch", SEED, 0.0, False, "cpu")
    assert not r["correct"], r["checks"]
