"""Online FastL: a streaming incremental pose-graph solver with no final
pattern.

Port of slam_plus_plus_tpu/solvers/fastl_online.py.  The reference FastL
consumes a stream: its block ordering grows as vertices arrive
(p_ExtendBlockOrdering_with_SubOrdering, reference
include/slam/OrderingMagic.h:291) and R grows without knowing the future.
The replay FastLSolver (solvers/fastl.py) plans over the final pattern;
this engine wraps it the JAX package's way:

  * vertex capacity doubling: the engine is built over a predicted padded
    system, the edges seen so far plus placeholder odometry-chain edges
    (v, v+1) up to the capacity.  A chain arrival overwrites its
    placeholder's measurement row and runs FastL's omega / activation step;
  * the loop-closure fringe as a Woodbury correction: a closure's lambda
    pairs are not in the predicted pattern, so its PSD contribution G G^T
    (G = J^T chol(info), two blocks) is carried as a low-rank term.
    X = lambda0^-1 G is kept on the device, all of its columns solved in
    one multi-column call of the maintained factor, the Gram G^T X is one
    contraction, and a solve is corrected by
        dx = base - X (I + G^T X)^-1 G^T base;
  * amortized rebuilds: when the vertex capacity or the fringe capacity
    overflows, the engine is rebuilt over the grown graph (the closures
    merge into the pattern, the fringe clears); stats["rebuilds"] counts
    them, O(log n) from doubling plus O(closures / FRINGE_CAP).

FastL's semantics (frozen linearization, omega updates, a push on a large
|dx|) come from the wrapped engine's public parts: FastLSolver.rebuild,
walk and absorb (which chooses the dirty refresh or the full redescent),
IncrementalCholesky.solve and Assembler.place_vertex.  The engine serves
the SE(2) odometry / closure edges of a streamed pose graph (``edge_pose2d``, the JAX package's
default and its only caller's) and runs float64 on both devices
(config.float64_dtype, as FastL).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import edge_linearization
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver

#: the streamed edge type
EDGE = "edge_pose2d"


class OnlineFastLSolver:
    """Streaming pose-graph FastL on one device.

    Usage:
        s = OnlineFastLSolver(device="cuda")
        for (i, j, z, info) in stream:
            s.add_edge(i, j, z, info)
        chi2, stats = s.finish()
    """

    #: vertices buffered before the first engine is built
    BOOTSTRAP_VERTICES = 8
    #: loop closures carried in the Woodbury fringe before a rebuild
    FRINGE_CAP = 64

    def __init__(self, *, device, initial_capacity: int = 256):
        """The engine's FastL settings are the CLI's -nsp 1 -fL ones
        (FastLSolver's defaults: a solve at every new vertex while a closure
        is pending, at most 10 iterations, |dx| threshold 20)."""
        self.device = torch.device(device)
        self.et = EDGE_TYPES[EDGE]
        self.capacity = initial_capacity
        self.seen: List[tuple] = []      # (i, j, z, info) in arrival order
        self.n_vertices = 0
        self.stats: Dict[str, float] = dict(rebuilds=0, solves=0, pushes=0, closures=0,
                                            steps=0, rebuild_seconds=0.0,
                                            solve_seconds=0.0)
        self.fs: Optional[FastLSolver] = None
        self._host_states = None
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # engine lifecycle
    # ------------------------------------------------------------------

    def _build_engine(self) -> None:
        """(Re)build the engine over every seen edge plus the predicted
        odometry chain up to the capacity."""
        t0 = time.perf_counter()
        self.stats["rebuilds"] += 1
        system = GraphSystem()
        for (i, j, z, info) in self.seen:
            system.add_edge(EDGE, [i, j], z, info)
        # chain placeholders: identity measurement, unit information; the
        # arrival overwrites them, and inactive edges are masked to zero
        m = len(self.seen[0][2])
        self._chain_li = {}
        for v in range(self.n_vertices - 1, self.capacity - 1):
            system.add_edge(EDGE, [v, v + 1], np.zeros(m), np.eye(m))
            self._chain_li[v + 1] = system.edge_stores[EDGE].n - 1
        fs = FastLSolver(system, device=self.device)
        self.fs = fs
        # carry the optimized states over from the previous engine
        if self._host_states is not None:
            for t, arr in self._host_states.items():
                n = min(len(arr), system.vertex_stores[t].n)
                system.vertex_stores[t].states[:n] = arr[:n]
        self._states = fs.asm.snapshot_states(system)
        self._counts = {n: 0 for n in fs.asm.edge_data}
        self._counts[EDGE] = len(self.seen)
        self._n_active = self.n_vertices
        self._stores, self._eta0 = fs.rebuild(self._states, dict(self._counts), self._n_active)
        self._pending: List[tuple] = []
        self._outstanding = False
        self._lin_dirty = True
        self._last_nap = self.n_vertices
        # the fringe: per closure its class slots, measurement and local
        # ids; on the device its G columns as dense right-hand sides R
        # [Np*Bp, F], X = lambda0^-1 R and the Gram R^T X
        self._fringe: List[dict] = []
        self._R = self._X = self._gram = None
        self.stats["rebuild_seconds"] += time.perf_counter() - t0

    def _ensure_engine(self) -> None:
        if self.fs is None:
            while self.capacity < self.n_vertices:
                self.capacity *= 2
            self._build_engine()

    def _snapshot_states(self) -> None:
        if self.fs is None:
            return
        fs = self.fs
        fs.asm.writeback_states(fs.system, self._states)
        self._host_states = {t: np.array(fs.system.vertex_stores[t].data)
                             for t in fs.asm.type_names}

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    def add_edge(self, i: int, j: int, z, info) -> None:
        z = np.asarray(z, dtype=np.float64)
        info = np.asarray(info, dtype=np.float64)
        self.stats["steps"] += 1
        self.seen.append((i, j, z, info))
        new_vertex = max(i, j) >= self.n_vertices
        if new_vertex:
            # the first edge brings both endpoints; afterwards ids grow one
            # at a time (the reference's FlatSystem semantics)
            if max(i, j) != self.n_vertices and len(self.seen) != 1:
                raise ValueError("online mode requires incremental vertex ids")
            self.n_vertices = max(i, j) + 1

        if self.fs is None:
            # buffer a short prefix, then build the first engine (all the
            # buffered edges land in its pattern)
            if self.n_vertices >= self.BOOTSTRAP_VERTICES:
                self._ensure_engine()
            return

        chain_arrival = (new_vertex and j == i + 1 and j in self._chain_li
                         and max(i, j) == self._n_active)
        if ((new_vertex and not chain_arrival) or self.n_vertices > self.capacity
                or len(self._fringe) >= self.FRINGE_CAP):
            # growth or fringe overflow: rebuild over everything seen
            while self.capacity < self.n_vertices:
                self.capacity *= 2
            self._snapshot_states()
            self._build_engine()
            if not new_vertex:
                # the closure that triggered the rebuild gets its solve
                self._outstanding = False
                self._solve_point()
            return
        self._ingest_last()

    def _ingest_last(self) -> None:
        (i, j, z, info) = self.seen[-1]
        asm = self.fs.asm
        if max(i, j) == self._n_active and j == max(i, j) and j in self._chain_li:
            li = self._chain_li[j]
            # overwrite the placeholder's measurement row
            data = asm.edge_data[EDGE]
            data["z"][li] = torch.as_tensor(z, dtype=asm.dtype)
            data["info"][li] = torch.as_tensor(info, dtype=asm.dtype)
            # place the new vertex from the edge at the current states
            self._states = asm.place_vertex(self._states, EDGE, 1, li)
            self._counts[EDGE] += 1
            self._n_active += 1
            self._pending.append((EDGE, li, np.array([0.0, 1.0])))
        else:
            # a loop closure goes to the fringe
            self.stats["closures"] += 1
            self._outstanding = True
            self._add_fringe(i, j, z, info)

        if (self._n_active - self._last_nap) < self.fs.every_n:
            return
        self._last_nap = self._n_active
        if not self._outstanding:
            return
        self._outstanding = False
        self._solve_point()

    # ------------------------------------------------------------------
    # the fringe (Woodbury) machinery
    # ------------------------------------------------------------------

    def _linearize(self, entries):
        """For a batch of fringe edges at the current states: chi2 [F_e],
        the gradients [F_e, 2, Bp] and the G columns [F_e, 2, Bp, m],
        G_k = J_k^T chol(info_w) with the Jacobians and the IRLS-weighted
        information of the assembler's linearization (edge_linearization),
        so that G G^T is the omega FastL adds to lambda."""
        asm = self.fs.asm
        dev, dt = asm.device, asm.dtype
        t0, t1 = self.et.vertex_types
        li = torch.as_tensor([e["li"] for e in entries], device=dev)
        lj = torch.as_tensor([e["lj"] for e in entries], device=dev)
        z = torch.as_tensor(np.stack([e["z"] for e in entries]), dtype=dt, device=dev)
        info = torch.as_tensor(np.stack([e["info"] for e in entries]), dtype=dt, device=dev)
        states = (self._states[t0][li], self._states[t1][lj])
        chi2, _h, gs, _Hpp, _Hll, _Hpl = asm._kernels[EDGE](states, z, info)
        _r, jacs, info_w = edge_linearization(self.et, states, z, info)
        L = torch.linalg.cholesky(info_w)
        G = [torch.nn.functional.pad(J.mT, (0, 0, 0, asm.Bp - J.shape[-1])) @ L for J in jacs]
        return chi2, torch.stack(list(gs), dim=1), torch.stack(G, dim=1)

    def _fringe_rhs(self, entries, G):
        """Dense right-hand sides [Np*Bp, F_e*m] of the entries' G columns."""
        asm = self.fs.asm
        Np, Bp = asm.Np, asm.Bp
        F_e, _two, _bp, m = G.shape
        R = torch.zeros((Np, Bp, F_e * m), dtype=G.dtype, device=G.device)
        cols = torch.arange(F_e * m, device=G.device).view(F_e, m)
        for k, key in enumerate(("i", "j")):
            rows = torch.as_tensor([e[key] for e in entries], device=G.device)
            # R[rows[f], :, cols[f, c]] = G[f, k, :, c]
            R[rows[:, None], :, cols] = G[:, k].permute(0, 2, 1)
        return R.view(Np * Bp, F_e * m)

    def _add_fringe(self, i, j, z, info) -> None:
        fs = self.fs
        asm = fs.asm
        sysd = fs.system.vertex_directory
        li, lj = sysd[i][1], sysd[j][1]
        t0, t1 = self.et.vertex_types
        entry = dict(i=int(asm.type_cslot[t0][li]), j=int(asm.type_cslot[t1][lj]),
                     z=z, info=info, li=li, lj=lj)
        _chi2, gs, G = self._linearize([entry])
        # eta is dense: the fringe gradients scatter straight in
        self._eta0.index_add_(0, torch.as_tensor([entry["i"], entry["j"]], device=asm.device),
                              gs[0])
        self._fringe.append(entry)
        R = self._fringe_rhs([entry], G)
        X = self._solve_columns(R)
        self._R = R if self._R is None else torch.cat([self._R, R], dim=1)
        self._X = X if self._X is None else torch.cat([self._X, X], dim=1)
        self._gram = self._R.T @ self._X

    def _solve_columns(self, R):
        """lambda0^-1 R: every column in one descent and ascent of the
        maintained factor."""
        asm = self.fs.asm
        k = R.shape[1]
        return self.fs.inc.solve(self._stores, R.view(asm.Np, asm.Bp, k)).reshape(-1, k)

    def _resolve_X(self) -> None:
        """X for the current factor (the same linearization)."""
        if self._fringe:
            self._X = self._solve_columns(self._R)
            self._gram = self._R.T @ self._X

    def _woodbury(self, base):
        """dx = base - X (I + G^T X)^-1 (G^T base)."""
        if not self._fringe:
            return base
        F = self._X.shape[1]
        y = self._R.T @ base.reshape(-1)
        w = torch.linalg.solve(torch.eye(F, dtype=base.dtype, device=base.device)
                               + self._gram, y)
        return base - (self._X @ w).view_as(base)

    def _refresh_fringe(self) -> None:
        """Relinearize every fringe edge at the current states (after a
        push): its gradient into eta0, its G columns, X."""
        if not self._fringe:
            return
        _chi2, gs, G = self._linearize(self._fringe)
        rows = torch.as_tensor([[e["i"], e["j"]] for e in self._fringe],
                               device=self.fs.asm.device)
        self._eta0.index_add_(0, rows.reshape(-1), gs.reshape(-1, gs.shape[-1]))
        self._R = self._fringe_rhs(self._fringe, G)
        self._resolve_X()

    # ------------------------------------------------------------------
    # solve / push
    # ------------------------------------------------------------------

    def _absorb(self, walk) -> None:
        """The pending chain edges into the factor (FastLSolver.absorb:
        the dirty refresh from walk, or the full redescent for None); X is
        then stale, so it is solved again."""
        self._stores = self.fs.absorb(self._stores, self._eta0, self._states, self._pending,
                                      walk)
        self._pending.clear()
        self._resolve_X()

    def _solve_point(self) -> None:
        t0 = time.perf_counter()
        fs = self.fs
        self.stats["solves"] += 1
        if self._pending:
            self._absorb(fs.walk(self._pending))
        for _ in range(fs.max_iterations):
            dx = self._woodbury(fs.inc.solve(self._stores, self._eta0))
            norm = float(torch.linalg.vector_norm(dx))
            if not np.isfinite(norm) or norm > 1e5 or norm <= fs.dx_threshold:
                self._lin_dirty = True
                break
            # push
            self.stats["pushes"] += 1
            self._lin_dirty = False
            self._states = fs.asm.update(self._states, dx, None)
            self._stores, self._eta0 = fs.rebuild(self._states, dict(self._counts),
                                                  self._n_active)
            self._refresh_fringe()
        self.stats["solve_seconds"] += time.perf_counter() - t0

    # ------------------------------------------------------------------

    def _fringe_chi2(self) -> float:
        return float(self._linearize(self._fringe)[0].sum()) if self._fringe else 0.0

    def chi2(self) -> float:
        return float(self.fs.asm.chi2_active(self._states, self._counts)) + self._fringe_chi2()

    def finish(self):
        """The final one-time dx (the reference's CalculateOneTimeDx
        reporting) and chi2.  Returns (chi2, stats)."""
        self._ensure_engine()
        fs = self.fs
        if self._pending:
            # the full redescent, as the replay's trailing edges take it
            self._absorb(None)
            self._lin_dirty = True
        if self._lin_dirty:
            dx = self._woodbury(fs.inc.solve(self._stores, self._eta0))
            if bool(torch.isfinite(dx).all()):
                self._states = fs.asm.update(self._states, dx, None)
        self.stats["elapsed"] = time.perf_counter() - self._t0
        return self.chi2(), self.stats
