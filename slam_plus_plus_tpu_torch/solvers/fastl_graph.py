"""FastL's solve point as one CUDA graph.

A solve point whose reachability walk fits the capacities runs a chain of
a few thousand short kernels: omega (FastLSolver._omega, once per batch of
OMEGA_EDGE_CAP edges of one type), the dirty refresh
(IncrementalCholesky._dirty_scan) and the solve
(IncrementalCholesky.solve_with_norm).  Every shape in it is fixed by the
plan and by the batches' types (each batch is padded to OMEGA_EDGE_CAP
edges, every level of the walk runs at the same capacities), and the
chain reads nothing back on the host.  So on a CUDA device the
chain of each sequence of batch types (its key: one batch of one type at
nearly every solve point of every_n = 1) is captured once and replayed: a
solve point then costs the packing of its indices, one host-to-device copy
and one graph launch.

The runner owns what the chain reads and writes, at fixed addresses:

  * one pinned host staging buffer and its device copy, sized from the
    plan: the batches' indices (FastLSolver._chunk_host) and the packed
    walk (IncrementalCholesky.pack), a key's layout a prefix of it;
  * the factor stores the chain updates in place (``STATIC``), eta0 and
    the states.  Where the replay swaps in fresh tensors (a rebuild after a
    push or an overflow, a state update, a new run) :meth:`hold` and
    :meth:`hold_states` copy their values into the held ones;
  * each graph's outputs: dx, |dx| and the bottom factor (L, s), which the
    held stores point to after its replay.

On a CUDA device the first solve point with a batch of an edge type runs
eagerly on a side stream (the warm-up); a later key without a graph is
captured on that stream into a private pool, with the sync debug mode
raising on any host synchronization, then replayed; the graphs live as
long as the solver.  A capture that fails leaves the solver eager for
good, with a warning, and ``capture_failure`` says why.  On the CPU every
point runs the same chain eagerly from the same buffers.

Tracer (utils/timer.py): the span ``fastl.graph_replay`` around a replay's
copy and launch, so a device trace credits the graph's kernels to it (the
chain's ``fastl.omega``, ``inc.refresh`` and ``inc.solve`` spans then run
at the warm-up and the captures only); ``fastl.pack`` around the packing;
counters ``fastl.graph_replays``, ``fastl.graph_captures`` and, for a
solve point that did not replay, ``fastl.graph_eager.<reason>``
(FastLSolver counts the reasons found before the runner).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch

from slam_plus_plus_tpu_torch.linalg.incremental_cholesky import OMEGA_CAP
from slam_plus_plus_tpu_torch.utils import cuda_graph
from slam_plus_plus_tpu_torch.utils.timer import count, span

#: the factor stores the chain reads at fixed addresses ("L" and "s" it
#: computes)
STATIC = ("H", "C", "W", "P", "dense", "sv", "outer0")


class SolvePointRunner:
    """The solve points of one FastLSolver (see the module docstring).

    Usage (inside FastLSolver's replay):
        stores, eta0 = runner.hold(stores, eta0)    # after each rebuild
        states = runner.hold_states(states)         # after each new states
        dx, norm = runner.run(chunks, host_packed)  # a solve point
    """

    def __init__(self, fl):
        self.fl = fl
        self.inc = inc = fl.inc
        asm = fl.asm
        self.device = dev = asm.device
        cuda = dev.type == "cuda"
        self.eager_reason: Optional[str] = None if cuda else dev.type
        self.capture_failure: Optional[str] = None
        # per edge type: (a batch's index length, its omega contributions)
        self._lens = {}
        for plan in asm.plans:
            sizes = fl._chunk_sizes(plan.name)
            self._lens[plan.name] = (sum(sizes), sizes[3])
        # a walk takes at most OMEGA_CAP contributions, so the batches'
        # indices take at most OMEGA_CAP times the most a contribution brings
        most = max(-(-OMEGA_CAP * a // c) for a, c in self._lens.values())
        n = most + inc.packed_len(OMEGA_CAP)
        self.stage = torch.zeros(n, dtype=torch.int64, pin_memory=cuda)
        self._stage_np = self.stage.numpy()
        self.dev_in = torch.zeros(n, dtype=torch.int64, device=dev)
        self.stores: Optional[Dict[str, torch.Tensor]] = None
        self.eta0 = None
        self.states: Optional[Dict[str, torch.Tensor]] = None
        self._warm = set()          # edge types whose chain has run once
        # per key (the batches' types): the graph and its outputs
        self._graphs: Dict[tuple, tuple] = {}
        self._side = torch.cuda.Stream(device=dev) if cuda else None
        self._copied = torch.cuda.Event() if cuda else None
        self.counts = dict(replays=0, captures=0, eager=0)

    # ------------------------------------------------------------------
    # held state
    # ------------------------------------------------------------------

    def hold(self, stores, eta0):
        """The held stores and eta0 with the values of these: the first
        ones become the held ones, later ones are copied into them."""
        if self.stores is None:
            self.stores, self.eta0 = stores, eta0
        else:
            if stores is not self.stores:
                for k in STATIC:
                    self.stores[k].copy_(stores[k])
                self.stores["L"], self.stores["s"] = stores["L"], stores["s"]
            if eta0 is not self.eta0:
                self.eta0.copy_(eta0)
        return self.stores, self.eta0

    def hold_states(self, states):
        """The held states with the values of these (as :meth:`hold`)."""
        if self.states is None:
            self.states = states
        elif states is not self.states:
            for t, x in states.items():
                self.states[t].copy_(x)
        return self.states

    # ------------------------------------------------------------------
    # the solve point
    # ------------------------------------------------------------------

    def run(self, chunks, host_packed):
        """(dx, |dx|) of a solve point, on the held stores, eta0 and states:
        chunks are FastLSolver._pending_chunks' batches, host_packed their
        walk (IncrementalCholesky.prepare_host_batch's, not None)."""
        key = tuple(en for (en, _els, _nmc, _valid) in chunks)
        with span("fastl.pack"):
            if self._copied is not None:
                self._copied.synchronize()     # the last copy has read the stage
            off = 0
            for (en, els, nmc, valid) in chunks:
                a = self._lens[en][0]
                self._stage_np[off:off + a] = self.fl._chunk_host(en, els, nmc, valid)
                off += a
            n = off + self.inc.packed_len(len(host_packed[0]))
            self.inc.pack(host_packed, self._stage_np[off:n])
        if self.eager_reason is not None:
            return self._eager(key, n, self.eager_reason)
        if not self._warm.issuperset(key):
            self._warm.update(key)
            return cuda_graph.on_side(self._side, self.device,
                                      lambda: self._eager(key, n, "warm_up"))
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(key)
            if g is None:
                return self._eager(key, n, "capture_failed")
            self._graphs[key] = g
        graph, dx, norm, L, s = g
        self.counts["replays"] += 1
        count("fastl.graph_replays")
        with span("fastl.graph_replay"):
            self._copy(n)
            graph.replay()
        self.stores["L"], self.stores["s"] = L, s
        return dx, norm

    def _copy(self, n):
        self.dev_in[:n].copy_(self.stage[:n], non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def _chain(self, key):
        """The device chain of the batches' types key, from dev_in and the
        held buffers: FastLSolver.absorb's omega batches and dirty refresh,
        then the solve."""
        fl, inc, st = self.fl, self.inc, self.stores
        off, vals = 0, []
        with span("fastl.omega"):
            for en in key:
                a = self._lens[en][0]
                ix = fl._chunk_views(en, self.dev_in[off:off + a])
                vals.append(fl._omega(en, self.states, st["H"], self.eta0, st["outer0"], ix))
                off += a
        scaled = torch.cat(vals) if len(vals) > 1 else vals[0]
        with span("inc.refresh"):
            inc._dirty_scan(st, scaled, *inc.unpack(self.dev_in[off:], scaled.shape[0]))
        return inc.solve_with_norm(st, self.eta0)

    def _eager(self, key, n, reason):
        self.counts["eager"] += 1
        count(f"fastl.graph_eager.{reason}")
        self._copy(n)
        return self._chain(key)

    def _capture(self, key):
        """The chain of key captured on the side stream: (graph, dx, norm,
        L, s), or None (the solver stays eager) if the capture fails."""
        try:
            graph, (dx, norm) = cuda_graph.capture(self._side, self.device,
                                                   lambda: self._chain(key))
        except Exception as e:
            self.capture_failure = f"{key}: {e}"
            self.eager_reason = "capture_failed"
            warnings.warn(f"FastL solve point not captured as a CUDA graph ({e}); the "
                          f"solver runs every point eagerly", RuntimeWarning, stacklevel=3)
            return None
        self.counts["captures"] += 1
        count("fastl.graph_captures")
        return graph, dx, norm, self.stores["L"], self.stores["s"]
