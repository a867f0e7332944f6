"""FastL: incremental solver with a maintained factorization (omega updates).

Port of slam_plus_plus_tpu/solvers/fastl.py (reference
CNonlinearSolver_FastL, include/slam/NonlinearSolver_FastL.h — the RSS-2013
incremental solver).  Its semantics, as the reference's:

  * linearization points are FROZEN between optimization pushes; lambda and
    the factor are *updated* with the new edges' Hessian contributions
    (omega, fL_util::Calculate_Omega, NonlinearSolver_FastL.h:698,743)
    rather than rebuilt;
  * a solve runs at an every-N boundary only while loop closures are
    outstanding (TryOptimize, NonlinearSolver_FastL.h:1451-1566);
  * if |dx| exceeds the threshold the step is PUSHED: every vertex moves
    and the next factorization is a full relinearization + refactorization
    (Refresh_R_FullR, NonlinearSolver_FastL.h:2367); otherwise dx is
    discarded and the frozen linearization survives (break-before-push).

The mechanism is the JAX package's: lambda lives as the level-0 blocks of
the nested MIS-Schur plan (linalg/block_cholesky.py) over the final replay
pattern, in one mixed class (landmarks included, eliminated by the first
levels); an omega step scatter-adds the pending edges' Hessian blocks into
lambda, and then the dirty refresh recomputes only the reachable factor
blocks (linalg/incremental_cholesky.py), or, where the solve point's walk
overflows a capacity, the full redescent recomputes every level.
:meth:`FastLSolver.absorb` is the one place that chooses between them.

With ``marginals=True`` the per-vertex covariance diagonal is maintained
inside the loop at every solve point (the JAX package's in-loop marginals
under its default MarginalsPolicy; reference
NonlinearSolver_Lambda.h:670-705, Marginals.h:5224): after a push the
recurrent recovery from the maintained factor, at a solve point without
one the Woodbury update through it; ``marginals_trace`` logs each
decision.

The engine runs float64 on both devices (config.float64_dtype).  Host
syncs: one read of |dx| per iteration.  The whole replay's reachability
walks are done at construction (the solve schedule is host-static).  A
solve point whose walk fits the capacities runs through the solve-point
runner (solvers/fastl_graph.py), which uploads everything the point needs
in one copy and, on a CUDA device, replays the point's omega, dirty
refresh and solve as one CUDA graph.

Tracer spans (utils/timer.py, off by default): ``fastl.replay`` around a
run, ``fastl.solve_point`` around each solve point, and inside them
``fastl.flush``, ``fastl.omega``, ``inc.refresh``, ``inc.solve``,
``fastl.pack``, ``fastl.graph_replay``, ``fastl.update``, ``fastl.rebuild``
and ``host_sync`` (each read of a device value); counters
``fastl.pending_edges`` and ``inc.dirty_blocks`` per solve point, with
``fastl.pending_edges.<edge type>`` beside the total and
``inc.walk_levels`` (the elimination levels the point's walk reaches),
``fastl.activations.<vertex type>`` per flush (the vertices it places), and
one of ``fastl.graph_replays`` or ``fastl.graph_eager.<reason>`` per solve
point (``fastl.graph_captures`` per capture).

``native=True`` (on the CPU only) builds the host half alone — the
assembler, the plan, the steps and the omega metadata — and hands the
replay to the C++ engine (solvers/native_engine.py), which serves SE(2)
and 2D-landmark graphs in float64 with the dirty refresh and no marginals;
any other replay raises instead of running on the torch engine.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
from slam_plus_plus_tpu_torch.config import SolverSettings, float64_dtype, pin_precision
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
from slam_plus_plus_tpu_torch.linalg.incremental_cholesky import IncrementalCholesky
from slam_plus_plus_tpu_torch.marginals.covariance import IncrementalMarginals
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu_torch.ops.segsum import index_add_ordered
from slam_plus_plus_tpu_torch.solvers.fastl_graph import SolvePointRunner
from slam_plus_plus_tpu_torch.solvers.native_engine import NativeReplay, check_supported
from slam_plus_plus_tpu_torch.utils.timer import count, enabled, span

#: edges of one type per omega batch; larger pending batches are chunked
OMEGA_EDGE_CAP = 16
#: dense bottom of the factor plan, in blocks: the dirty step refactors it
#: every step, so its size sets the per-step floor; the levels above it pay
#: only for what the step reaches
BOTTOM = 32
#: Woodbury columns past which the in-loop marginals recompute instead
SIGMA_UPDATE_MAX_COLS = 96


def replay_steps(system: GraphSystem) -> List[dict]:
    """Per inserted edge, in insertion order: its type and local index, the
    vertices it introduces as (slot, global id), the reference's
    loop-closure flag (NonlinearSolver_Base.h:505-539) and the number of
    active vertices after it."""
    order_of = {g: i for i, g in enumerate(system.vertex_order)}
    seen = set()
    steps: List[dict] = []
    n_active = 0
    for (ename, li) in system._edge_insert_log:
        vids = system.edge_stores[ename].vertex_ids[li]
        new_vs = []
        for slot, gid in enumerate(vids):
            if gid not in seen:
                seen.add(gid)
                new_vs.append((slot, int(gid)))
                n_active += 1
        n = len(vids)
        first = min(order_of[g] for g in vids)
        closure = (first + n < n_active) if n > 1 else False
        steps.append(dict(ename=ename, li=li, new_vs=new_vs, closure=closure,
                          n_active=n_active))
    return steps


class FastLSolver:
    """Incremental FastL replay over a parsed system on one device.

    Usage:
        inc = FastLSolver(system, device="cuda", every_n=1)
        chi2, iters = inc.run()
    """

    #: the factor's refresh at a solve point: the dirty one, the full
    #: redescent where a walk overflows (the benchmark's route line reads it)
    refresh = "dirty"

    def __init__(self, system: GraphSystem, *, device, every_n: int = 1,
                 max_iterations: int = 10, dx_threshold: float = 20.0,
                 onetime_dx: bool = True, marginals: bool = False, native: bool = False):
        """onetime_dx=False gives the reference LAMBDA solver's incremental
        report: chi2 and the solution at the last pushed linearization, no
        trailing one-time dx (its Optimize discards a below-threshold dx,
        reference NonlinearSolver_Lambda.h:637-661).  Between pushes the
        linearization is frozen, so lambda maintained by omega updates
        equals the lambda solver's full Refresh_Lambda: one engine serves
        both solvers.  marginals: maintain the covariance diagonal in the
        loop, from the maintained stores.  native: run the replay by the C++
        engine (raises UnsupportedReplay, naming the reason, where it does
        not serve the replay)."""
        if not system.edge_stores:
            raise ValueError("cannot replay an empty system (no edges)")
        if native:
            check_supported(system, device=device, marginals=marginals)
        t0 = time.perf_counter()
        pin_precision()
        self.system = system
        self.every_n = every_n
        self.max_iterations = max_iterations
        self.dx_threshold = dx_threshold
        self.onetime_dx = onetime_dx
        self.marginals = marginals
        self.marginals_trace: List[str] = []
        self._sigma_diag = None
        self._sigma_pending: List[tuple] = []
        # one mixed class: landmarks are low-degree candidates the MIS
        # elimination takes in its first levels, the reference FastL's
        # uniform treatment of landmark blocks in R
        self.asm = asm = Assembler(system, device=device, settings=SolverSettings(
            schur_split="off", edge_layout="flat"), dtype=float64_dtype(device))
        assert asm.Nl == 0, "the mixed-class assembler split a class off"
        self.chol = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp,
                                        device=asm.device, bottom=min(asm.Np, BOTTOM))
        # pp pair index (assembler order) -> level-0 position (plan order)
        self._inv_input_perm = np.empty(len(asm.pp_rows), dtype=np.int64)
        self._inv_input_perm[self.chol.plan.input_perm] = np.arange(len(asm.pp_rows))
        self.steps = replay_steps(system)
        self._build_replay_plan()

        self.inc = None        # the C++ engine keeps its own factor: no torch stores
        self._runner = None    # the solve points' runner, built by the first replay
        self._native = NativeReplay(self) if native else None
        # per solve point with pending edges, its walk (None: an overflow)
        self._prepared_all: Dict[int, object] = {}
        if not native:
            self.inc = IncrementalCholesky(self.chol)
            self._walk_schedule()
            # replay-sized capacities: the walks measured the actual
            # per-solve sizes, so rebuild at their 97th percentile (rounded
            # up to 16); the rare larger solve point takes the full
            # redescent instead of padding every other one
            psz = self.inc.last_batch_per_solve
            tight = {k: int(np.ceil((np.percentile(psz[k], 97) + 1) / 16) * 16)
                     for k in ("d", "e", "w", "p")} if self._sched else {}
            if any(tight[k] < getattr(self.inc, f"cap_{k}") - 16 for k in tight):
                self.inc = IncrementalCholesky(self.chol, caps=tight)
                self._walk_schedule()
        self.stats: Dict[str, float] = {}
        self.timing = {"construct": time.perf_counter() - t0}

    # ------------------------------------------------------------------

    def _build_replay_plan(self) -> None:
        """Host precompute: per edge type the omega scatter metadata, and
        the deterministic solve schedule."""
        asm = self.asm
        # per edge type: the level-0 position of each pp contribution and
        # its transpose-on-store flag (the plan's level-0 storage is the
        # sorted pattern; assembler order maps through input_perm)
        self._omega_meta = {}
        for plan in asm.plans:
            pos = [self._inv_input_perm[np.asarray(s)] for (_a, _b, s, _w) in plan.pp_contribs]
            swaps = [np.asarray(w) for (_a, _b, _s, w) in plan.pp_contribs]
            self._omega_meta[plan.name] = (pos, swaps)

        # the solve schedule (mirrors run() exactly): per solve point, the
        # pending batch's level-0 dirty positions
        self._sched: Dict[int, list] = {}
        pending_meta: List[tuple] = []
        outstanding = False
        last_nap = 0
        started = False
        for si, step in enumerate(self.steps):
            pending_meta.append((step["ename"], step["li"],
                                 np.zeros(EDGE_TYPES[step["ename"]].arity)))
            outstanding = outstanding or step["closure"]
            if step["n_active"] - last_nap < self.every_n:
                continue
            last_nap = step["n_active"]
            if not started:
                started = True
                pending_meta = []
            if not outstanding:
                continue
            outstanding = False
            if pending_meta:
                self._sched[si] = self._pending_pos(pending_meta)
                pending_meta = []

    def _walk_schedule(self) -> None:
        """Every scheduled solve point's walk at the engine's capacities,
        in one vectorized pass, into _prepared_all."""
        keys = sorted(self._sched)
        self._prepared_all = dict(zip(keys, self.inc.prepare_host_batch(
            [self._sched[si] for si in keys])))

    # ------------------------------------------------------------------
    # omega: new edges' Hessian blocks into the maintained lambda
    # ------------------------------------------------------------------

    def _pending_chunks(self, pending):
        """Deterministic per-type chunking of a pending batch, each padded
        to OMEGA_EDGE_CAP with a valid edge of the chunk (its positions are
        already dirty, so padding adds nothing to the walk) marked
        valid = 0."""
        cap = OMEGA_EDGE_CAP
        by_type: Dict[str, list] = {}
        for (en, el, nm) in pending:
            by_type.setdefault(en, []).append((el, nm))
        out = []
        for en, items in by_type.items():
            els = np.array([el for el, _ in items], dtype=np.int64)
            nms = np.array([nm for _, nm in items], dtype=np.float64)
            for lo in range(0, len(els), cap):
                chunk, nmc = els[lo:lo + cap], nms[lo:lo + cap]
                npad = cap - len(chunk)
                valid = np.ones(cap)
                if npad:
                    chunk = np.concatenate([chunk, np.full(npad, chunk[0], dtype=np.int64)])
                    nmc = np.concatenate([nmc, np.zeros((npad,) + nms.shape[1:])])
                    valid[len(els) - lo:] = 0.0
                out.append((en, chunk, nmc, valid))
        return out

    def _pending_pos(self, pending):
        """Level-0 dirty pair positions of a pending batch (host only), in
        the omega batch's contribution-major order."""
        return [np.stack([p[chunk] for p in self._omega_meta[en][0]]).reshape(-1)
                for (en, chunk, _nmc, _valid) in self._pending_chunks(pending)]

    def _chunk_sizes(self, en):
        """The lengths of an omega batch's index parts, in _chunk_host's
        order, for a batch of OMEGA_EDGE_CAP edges of type en."""
        plan = self.asm.plan_of[en]
        cap, ar, C = OMEGA_EDGE_CAP, len(plan.slot_local), len(plan.pp_contribs)
        return [cap, ar * cap, ar * cap, C * cap, C * cap, ar * cap, cap]

    def _chunk_host(self, en, chunk, nmc, valid):
        """One omega batch's host indices, flat int64: the edges, each slot's
        vertex and class slot, each contribution's level-0 position and swap
        flag, the new-vertex mask and validity."""
        plan = self.asm.plan_of[en]
        pos, swaps = self._omega_meta[en]
        parts = ([chunk] + [loc[chunk] for loc in plan.slot_local]
                 + [cs[chunk] for cs in plan.slot_cslot]
                 + [np.stack([p[chunk] for p in pos]).reshape(-1)]
                 + [np.stack([w[chunk] for w in swaps]).reshape(-1)]
                 + [nmc.T.reshape(-1), valid])
        return np.concatenate(parts).astype(np.int64)

    def _chunk_views(self, en, flat):
        """The omega batch's indices as _omega takes them, from _chunk_host's
        layout on the device."""
        sizes = self._chunk_sizes(en)
        cap, ar, C = sizes[0], sizes[1] // sizes[0], sizes[3] // sizes[0]
        eidx, local, cslot, posf, swap, new, valid = torch.split(flat, sizes)
        return dict(eidx=eidx, local=local.view(ar, cap), cslot=cslot.view(ar, cap),
                    pos=posf, swap=swap.view(C, cap).bool(),
                    new=new.view(ar, cap).to(self.asm.dtype), valid=valid.to(self.asm.dtype))

    def _upload_chunk(self, en, chunk, nmc, valid):
        """One omega batch's host indices on the device in one copy."""
        return self._chunk_views(en, torch.from_numpy(self._chunk_host(en, chunk, nmc, valid)).to(
            self.asm.device, non_blocking=True))

    def _omega(self, en, states, H, eta0, outer0, ix):
        """Calculate_Omega (reference NonlinearSolver_FastL.h:698-743) for a
        padded batch of one edge type at the current states: its Hessian
        blocks, less the activation's unit pivot on each new vertex's
        diagonal, transposed where stored swapped, scaled by outer0 and
        added into H (level-0 rows) and eta0, in place.  Returns the
        scaled deltas [C*cap, B*B] in contribution-major order."""
        asm = self.asm
        plan = asm.plan_of[en]
        B = asm.Bp
        data = asm.edge_data[en]
        gathered = tuple(states[t].index_select(0, ix["local"][k])
                         for k, t in enumerate(plan.slot_types))
        z = data["z"].index_select(0, ix["eidx"])
        info = data["info"].index_select(0, ix["eidx"])
        _chi2, _hd, gs, Hpp, _hll, _hpl = asm._kernels[en](gathered, z, info)
        vals = []
        for ci, (a, b, _s, _w) in enumerate(plan.pp_contribs):
            Hblk = Hpp[ci]
            if a == b:
                # activation: remove the slot's inactive unit pivot
                Hblk = Hblk.clone()
                Hblk[:, asm._p_diag_cols] -= (ix["new"][a][:, None] *
                                              asm.p_mask_dev.index_select(0, ix["cslot"][a]))
            else:
                Hblk = torch.where(ix["swap"][ci][:, None], Hblk[:, asm._p_tperm], Hblk)
            vals.append(Hblk)
        valid = ix["valid"]
        scaled = (torch.stack(vals) * valid[None, :, None]).reshape(-1, B * B) * outer0[ix["pos"]]
        # edges of a batch that share a block add in batch order, on the card
        # as on the CPU (a fixed order: ops/segsum.py)
        index_add_ordered(H, ix["pos"], scaled)
        eta_vals = torch.stack(list(gs)) * valid[None, :, None]
        index_add_ordered(eta0, ix["cslot"].reshape(-1), eta_vals.reshape(-1, B))
        return scaled

    # ------------------------------------------------------------------
    # vertex activation
    # ------------------------------------------------------------------

    def _flush_activations(self, states):
        """Place the queued new vertices from their introducing edges at
        the current states, in order: vertex k+1 may be placed from vertex
        k's fresh state (the JAX scan's carry), so each is its own update
        of one row.  Between solve points nothing reads the new vertices,
        so they wait here until the next dispatch."""
        with span("fastl.flush"):
            if enabled():
                fed: Dict[str, int] = {}
                for (ename, slot, _eidx) in self._act_queue:
                    vt = EDGE_TYPES[ename].vertex_types[slot]
                    fed[vt] = fed.get(vt, 0) + 1
                for vt, n in fed.items():
                    count(f"fastl.activations.{vt}", n)
            for (ename, slot, eidx) in self._act_queue:
                states = self.asm.place_vertex(states, ename, slot, eidx)
            self._act_queue.clear()
        return states

    # ------------------------------------------------------------------
    # factor maintenance
    # ------------------------------------------------------------------

    def rebuild(self, states, counts, n_active):
        """(stores, eta0): lambda at the current linearization, factored in
        full (the reference's Refresh_R_FullR after a push,
        NonlinearSolver_FastL.h:2367)."""
        with span("fastl.rebuild"):
            bs = self.asm.assemble_active(states, counts, n_active, 0)
            return self.inc.init_stores(bs.pp_blocks[self.chol._input_perm]), bs.eta_p

    def walk(self, pending):
        """The reachability walk of a pending batch (as construction walks
        each scheduled solve point), None past the capacities."""
        return self.inc.prepare_host_batch([self._pending_pos(pending)])[0]

    def absorb(self, stores, eta0, states, pending, walk):
        """The pending edges into the maintained factor: their omega
        batches (one per OMEGA_EDGE_CAP chunk of a type) into lambda's
        level-0 rows and eta0, then the dirty refresh of the blocks the
        walk reaches, in place, or, where walk is None (a walk past the
        capacities), the full redescent into fresh stores.  Returns the
        stores."""
        vals = []
        with span("fastl.omega"):
            for (en, chunk, nmc, valid) in self._pending_chunks(pending):
                ix = self._upload_chunk(en, chunk, nmc, valid)
                vals.append(self._omega(en, states, stores["H"], eta0, stores["outer0"], ix))
        if walk is None:
            with span("fastl.rebuild"):
                return self.inc.refactor_full(stores)
        with span("inc.refresh"):
            vals = torch.cat(vals) if len(vals) > 1 else vals[0]
            self.inc._dirty_scan(stores, vals, *self.inc.upload(walk, vals.shape[0]))
        return stores

    def _solve_point(self, chunks, hp):
        """A solve point whose walk fits the capacities: the omega batches,
        the dirty refresh and the solve on the runner's held stores, eta0
        and states (a CUDA graph replay on the card)."""
        return self._runner.run(chunks, hp)

    # ------------------------------------------------------------------
    # marginals maintained inside the loop
    # ------------------------------------------------------------------

    def _sigma_recompute(self, stores):
        """The recurrent recovery from the maintained factor: the block
        diagonal of Sigma, per class slot."""
        Sig = self.chol.marginals_from_stores(stores, self.inc)
        self._sigma_diag = Sig[self.chol._diag_pos0]
        self.marginals_trace.append("recalculate")

    def _build_G(self, pend, states):
        """(G [Np*Bp, k], D [k]): the pending edges' square-root omega
        columns (sign +1) and, for each vertex they activated, the removal
        of its unit placeholder pivot (one unit column per tangent dim,
        sign -1); None past SIGMA_UPDATE_MAX_COLS columns, counted on the
        host before anything is built."""
        asm = self.asm
        Bp = asm.Bp
        by_type: Dict[str, list] = {}
        act_rows = []
        for (en, el, nm) in pend:
            by_type.setdefault(en, []).append(el)
            plan = asm.plan_of[en]
            for slot in np.flatnonzero(nm):
                cs = int(plan.slot_cslot[slot][el])
                d = min(Bp, VERTEX_TYPES[EDGE_TYPES[en].vertex_types[slot]].tangent_dim)
                act_rows.extend(cs * Bp + dd for dd in range(d))
        n_omega = sum(EDGE_TYPES[en].residual_dim * len(els) for en, els in by_type.items())
        if n_omega + len(act_rows) > SIGMA_UPDATE_MAX_COLS:
            return None
        cols = [IncrementalMarginals.omega_sqrt_for_edges(asm, states, en, els)
                for en, els in by_type.items()]
        if act_rows:
            A = torch.zeros((asm.Np * Bp, len(act_rows)), dtype=asm.dtype, device=asm.device)
            A[torch.as_tensor(act_rows, device=asm.device),
              torch.arange(len(act_rows), device=asm.device)] = 1.0
            cols.append(A)
        return (torch.cat(cols, dim=1),
                torch.tensor([1.0] * n_omega + [-1.0] * len(act_rows), dtype=asm.dtype,
                             device=asm.device))

    def _sigma_update(self, stores, G, D):
        """The Woodbury update of the diagonal through the current factor,
        which already holds omega, so it solves X' = Sigma' G (all k columns
        in one descent and ascent):

            Sigma'_diag = Sigma_diag - diag(X' (D - G^T X')^-1 X'^T)

        (Update_BlockDiagonalMarginals_FBS_ExOmega's Woodbury with the stale
        and fresh factors exchanged; the signs D = +/-1 take the activation
        downdates exactly)."""
        asm = self.asm
        Np, Bp, k = asm.Np, asm.Bp, G.shape[1]
        X = self.inc.solve(stores, G.reshape(Np, Bp, k)).reshape(G.shape)
        M = torch.linalg.inv(torch.diag(D) - G.mT @ X)
        Xb = X.reshape(Np, Bp, k)
        self._sigma_diag = self._sigma_diag - ((Xb @ M) @ Xb.mT).reshape(Np, Bp * Bp)
        self.marginals_trace.append("update")

    def _refresh_marginals(self, stores, states, pushed):
        """The decision at a solve point: recompute after a push, else the
        update of the edges added since the last solve point, or a
        recompute past SIGMA_UPDATE_MAX_COLS columns."""
        if not self.marginals:
            return
        if pushed or self._sigma_diag is None:
            self._sigma_recompute(stores)
        elif self._sigma_pending:
            GD = self._build_G(self._sigma_pending, states)
            if GD is None:
                self._sigma_recompute(stores)
            else:
                self._sigma_update(stores, *GD)
        self._sigma_pending.clear()

    def sigma_diag(self):
        """The maintained per-vertex covariance blocks [Np, Bp, Bp] on the
        solver's device (None without ``marginals``)."""
        if self._sigma_diag is None:
            return None
        return self._sigma_diag.reshape(self.asm.Np, self.asm.Bp, self.asm.Bp)

    # ------------------------------------------------------------------

    def run(self, verbose: bool = False):
        """Replay every edge with FastL semantics; returns (chi2, iterations).
        ``stats`` then holds the replay's counts and its wall seconds."""
        if self._native is not None:
            chi2, iters, self.stats = self._native.run()
            self.elapsed = self.timing["replay"] = self.stats["elapsed"]
            if verbose:
                print(f"fastl done (C++ engine): {self.stats}")
            return chi2, iters
        with span("fastl.replay"):
            chi2, total_iters = self._replay()
        if verbose:
            print(f"fastl done: {self.stats}")
        return chi2, total_iters

    def _replay(self):
        """run() on the torch engine: (chi2, iterations), ``stats`` set."""
        t0 = time.perf_counter()
        asm = self.asm
        if self._runner is None or self._runner.inc is not self.inc:
            self._runner = SolvePointRunner(self)
        runner = self._runner
        runner.counts = dict.fromkeys(runner.counts, 0)    # this run's
        # the runner holds the stores, eta0 and states its chain reads at
        # fixed addresses: fresh ones are copied into them
        hold, hold_states = runner.hold, runner.hold_states
        n_eager = 0     # solve points that took no fast path

        def eager(reason):
            nonlocal n_eager
            n_eager += 1
            count(f"fastl.graph_eager.{reason}")

        states = hold_states(asm.snapshot_states(self.system))
        counts = {n: 0 for n in asm.edge_data}
        self._act_queue: List[tuple] = []

        stores, eta0 = None, None
        lin_dirty = True   # report with the one-time dx unless a push lands last
        outstanding = False
        pending: List[tuple] = []   # (ename, li, new_mask)
        last_nap = 0
        total_iters = n_solves = n_pushes = n_full = n_overflows = n_steps_applied = 0

        for si, step in enumerate(self.steps):
            ename, li = step["ename"], step["li"]
            new_mask = np.zeros(EDGE_TYPES[ename].arity)
            for (slot, _gid) in step["new_vs"]:
                self._act_queue.append((ename, slot, li))
                new_mask[slot] = 1.0
            counts[ename] += 1
            outstanding = outstanding or step["closure"]
            pending.append((ename, li, new_mask))
            if step["n_active"] - last_nap < self.every_n:
                continue
            last_nap = step["n_active"]

            if stores is None:
                states = self._flush_activations(states)
                stores, eta0 = hold(*self.rebuild(states, dict(counts), step["n_active"]))
                pending.clear()
                n_full += 1

            # optimize only while loop closures are outstanding
            if not outstanding:
                continue
            outstanding = False
            # the solve point: its end is the host's read of |dx| (a device
            # read) unless every iteration pushed, when it ends on the
            # queued rebuild of the last push
            with span("fastl.solve_point", step=si, n_active=step["n_active"]):
                count("fastl.pending_edges", len(pending))
                if enabled():
                    by_type: Dict[str, int] = {}
                    for (en, _li, _nm) in pending:
                        by_type[en] = by_type.get(en, 0) + 1
                    for en, n in by_type.items():
                        count(f"fastl.pending_edges.{en}", n)
                states = self._flush_activations(states)

                # omega update of the maintained factor, lazily: the factor
                # between solves is never read and omega deltas are additive, so
                # all pending edges go in here at once
                fused_dx = None
                if pending and self.marginals:
                    self._sigma_pending.extend(pending)
                if not pending:
                    eager("no_omega")
                else:
                    walk = self._prepared_all[si]
                    if enabled():
                        count("inc.dirty_blocks", self.inc.dirty_blocks(walk))
                        count("inc.walk_levels", self.inc.walk_levels(walk))
                    if walk is not None:
                        # absorb's omega and dirty refresh, then the solve,
                        # as the runner's one chain
                        with span("fastl.omega"):
                            chunks = self._pending_chunks(pending)
                        fused_dx = self._solve_point(chunks, walk)
                    else:
                        eager("overflow")
                        stores, eta0 = hold(self.absorb(stores, eta0, states, pending, None),
                                            eta0)
                        n_full += 1
                        n_overflows += 1
                    pending.clear()
                    n_steps_applied += 1
                pushed = False
                for it in range(self.max_iterations):
                    total_iters += 1
                    if it == 0 and fused_dx is not None:
                        dx, norm_dev = fused_dx
                    else:
                        dx, norm_dev = self.inc.solve_with_norm(stores, eta0)
                    with span("host_sync"):
                        norm = float(norm_dev)
                    # a near-singular lambda can give an astronomically large
                    # finite step; pushing it destroys the state, so reject it
                    # like a failed Cholesky (NonlinearSolver_Lambda.h:666-668)
                    if not np.isfinite(norm) or norm > 1e5 or norm <= self.dx_threshold:
                        lin_dirty = True
                        break  # discard dx, keep the frozen linearization
                    # push: the linearization moves -> relinearize + refactor
                    with span("fastl.update"):
                        states = hold_states(asm.update(states, dx, None))
                    n_pushes += 1
                    pushed = True
                    lin_dirty = False
                    stores, eta0 = hold(*self.rebuild(states, dict(counts), step["n_active"]))
                    n_full += 1
            self._refresh_marginals(stores, states, pushed)
            n_solves += 1

        states = self._flush_activations(states)
        # trailing pending edges (closures with no new vertex): refresh the
        # factorization so the final solution includes them
        if stores is not None and pending:
            stores, eta0 = hold(self.absorb(stores, eta0, states, pending, None), eta0)
            pending.clear()
            lin_dirty = True

        # the reference reports chi2 / the solution at the linearization
        # plus the pending one-time dx when no push materialized it
        # (NonlinearSolver_FastL.h:582-605)
        if stores is not None and lin_dirty and self.onetime_dx:
            dx, _norm = self.inc.solve_with_norm(stores, eta0)
            with span("host_sync"):
                finite = bool(torch.isfinite(dx).all())
            if finite:
                with span("fastl.update"):
                    states = hold_states(asm.update(states, dx, None))

        chi2_dev = asm.chi2_active(states, counts)
        with span("host_sync"):
            chi2 = float(chi2_dev)
        asm.writeback_states(self.system, states)
        self.elapsed = self.timing["replay"] = time.perf_counter() - t0
        self.stats = dict(steps=len(self.steps), solve_points=n_solves,
                          omega_steps=n_steps_applied, pushes=n_pushes,
                          full_refactors=n_full, dirty_overflows=n_overflows,
                          iters=total_iters, elapsed=self.elapsed,
                          graph_replays=runner.counts["replays"],
                          graph_captures=runner.counts["captures"],
                          graph_eager=n_eager + runner.counts["eager"])
        return chi2, total_iters
