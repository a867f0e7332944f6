"""Batch nonlinear solver base (port of the Schur branch of
slam_plus_plus_tpu/solvers/gauss_newton.py::GaussNewtonSolver).

The port solves problems with an eliminated landmark class through the
dense Schur complement; the linear backends for pose graphs (dense, sparse
MIS-Schur block Cholesky, host oracle) are ROADMAP.md Queue 1 items 12 and 15.
"""

from __future__ import annotations

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
from slam_plus_plus_tpu_torch.config import pin_precision
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver


class GaussNewtonSolver:
    def __init__(self, system: GraphSystem, *, device):
        if not system.edge_stores:
            raise ValueError("cannot build a solver over an empty system "
                             "(no edges); add edges first")
        pin_precision()
        self.system = system
        self.asm = Assembler(system, device=device)
        self.timing = {}
        self._schur = SchurSolver(self.asm)

    def _solve(self, block_system):
        return self._schur.solve(block_system)

    def chi2(self) -> float:
        states = self.asm.snapshot_states(self.system)
        return float(self.asm.chi2(states))
