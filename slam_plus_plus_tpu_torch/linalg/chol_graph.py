"""The sparse-reduced Schur's block Cholesky as one CUDA graph per key.

SchurSolver's sparse-reduced branch factors and solves the reduced camera
system at every LM trial on one fixed SC pattern: the plan fixes every
shape of the chain (each level's pivot inverses, W products, carries and
fill sums, the dense bottom's scatter and Cholesky, the down and up sweeps
of the solve), only the values change.  Launched from the host that chain
is several hundred short kernels, whose launches set the pace of a solve
while the device idles.  So on a CUDA device the chain of each key (the
blocks' dtype and the rhs's shape) is captured once and replayed: a call
then costs two copies into held inputs, one graph launch and one read of
the bottom factor's status.

The float32 bottom's ridge ladder (``_equilibrated_cholesky``) reads the
factor's status after each rung; a graph cannot.  The graphed chain runs
the first rung only, leaves its status on the device and reads it once
after the replay, where the eager chain read it between the factor and the
solve.  A first rung that failed discards the replay's dx: the plain
``BlockCholeskySolver.solve`` then walks the whole ladder from the held
inputs, as every call did before.

On a CUDA device the first call of a key runs eagerly on a side stream
(the warm-up), the second is captured on that stream into a private pool,
with the sync debug mode raising on any host synchronization, then
replayed; later calls replay.  A capture that fails leaves the solver
eager for good, with a warning, and ``capture_failure`` says why.  On the
CPU every call runs the same chain eagerly from the same held inputs.
Each call returns a dx of its own (a replay's output is cloned).

Only the Schur's reduced system takes this class.  Every other caller of
the block Cholesky keeps the eager ``BlockCholeskySolver``: FastL's
maintained factor has its own graphed runner (solvers/fastl_graph.py), GN,
SPCG and the marginals factor once per system or read values inside their
own loops, and the distributed factor's collectives must not be captured.

Tracer (utils/timer.py): the span ``chol.graph_replay`` around a replay's
copies and launch, so a device trace credits the graph's kernels to it
(the chain's ``chol.factor``, ``chol.solve`` and ``chol.level`` spans then
run at the warm-up and the capture only); ``host_sync`` around the status
read; counters ``chol.graph_replays``, ``chol.graph_captures`` and, for a
call that did not replay or whose replay's first rung failed,
``chol.graph_eager.<reason>`` (``cpu``, ``warm_up``, ``capture_failed``,
``ridge``).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch

from slam_plus_plus_tpu_torch.linalg.block_cholesky import (
    RIDGE_LADDER, BlockCholeskyFactor, BlockCholeskySolver, _equilibrated_cholesky,
    _f32_equilibrated, _f32_rung)
from slam_plus_plus_tpu_torch.utils import cuda_graph
from slam_plus_plus_tpu_torch.utils.timer import count, span


class GraphedBlockCholeskySolver(BlockCholeskySolver):
    """BlockCholeskySolver whose ``solve`` runs as a CUDA graph per key
    (see the module docstring); ``factor``, ``solve_with_factor`` and the
    marginals are the base class's."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        cuda = self.device.type == "cuda"
        self.eager_reason: Optional[str] = None if cuda else self.device.type
        self.capture_failure: Optional[str] = None
        # per key: the held inputs (blocks, eta), and the graph with its outputs
        self._held: Dict[tuple, tuple] = {}
        self._graphs: Dict[tuple, tuple] = {}
        self._side = torch.cuda.Stream(device=self.device) if cuda else None

    def solve(self, blocks, eta):
        """Factor + solve, as ``BlockCholeskySolver.solve``: blocks [K, B*B]
        planar (caller's pair order), eta [N, B] (or [N, B, k])."""
        key = (blocks.dtype, tuple(eta.shape))
        held = self._held.get(key)
        if held is None:
            held = self._held[key] = (torch.empty_like(blocks), torch.empty_like(eta))
            if self.eager_reason is None:
                return cuda_graph.on_side(self._side, self.device,
                                          lambda: self._eager("warm_up", held, blocks, eta))
        if self.eager_reason is not None:
            return self._eager(self.eager_reason, held, blocks, eta)
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(held)
            if g is None:
                return self._eager("capture_failed", held, blocks, eta)
            self._graphs[key] = g
        graph, dx, ok = g
        count("chol.graph_replays")
        with span("chol.graph_replay"):
            self._hold(held, blocks, eta)
            graph.replay()
        return self._checked(held, dx.clone(), ok)

    @staticmethod
    def _hold(held, blocks, eta):
        held[0].copy_(blocks)
        held[1].copy_(eta)

    def _chain(self, blocks, eta):
        """(dx, ok): the factor with the float32 ladder's first rung only
        (ok its status on the device; None in float64, which has no
        ladder), then the solve."""
        with span("chol.factor"):
            dense, c_invs, Ws, sv = self._factor_levels(blocks)
            if dense.dtype == torch.float32:
                A, s = _f32_equilibrated(dense)
                L, ok = _f32_rung(A, RIDGE_LADDER[0])
            else:
                (L, s), ok = _equilibrated_cholesky(dense), None
        f = BlockCholeskyFactor(tuple(c_invs), tuple(Ws), L, s, sv)
        return self.solve_with_factor(f, eta), ok

    def _checked(self, held, dx, ok):
        """dx where the first rung gave a finite factor, else the plain
        solver's answer (the whole ladder) from the held inputs."""
        if ok is None:
            return dx
        with span("host_sync"):
            ok = bool(ok)
        if ok:
            return dx
        count("chol.graph_eager.ridge")
        return BlockCholeskySolver.solve(self, *held)

    def _eager(self, reason, held, blocks, eta):
        count(f"chol.graph_eager.{reason}")
        self._hold(held, blocks, eta)
        return self._checked(held, *self._chain(*held))

    def _capture(self, held):
        """The chain on the held inputs captured on the side stream:
        (graph, dx, ok), or None (the solver stays eager) if the capture
        fails."""
        try:
            graph, (dx, ok) = cuda_graph.capture(self._side, self.device,
                                                 lambda: self._chain(*held))
        except Exception as e:
            self.capture_failure = str(e)
            self.eager_reason = "capture_failed"
            warnings.warn(f"block Cholesky solve not captured as a CUDA graph ({e}); the "
                          f"solver runs every call eagerly", RuntimeWarning, stacklevel=3)
            return None
        count("chol.graph_captures")
        return graph, dx, ok
