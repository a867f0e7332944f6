"""Incremental Lambda-DL: dogleg with fluid relinearization and an
incrementally maintained Schur complement.

Port of slam_plus_plus_tpu/solvers/dogleg_incremental.py (reference
CNonlinearSolver_Lambda_DL, include/slam/NonlinearSolver_Lambda_DL.h:242-1560,
3DV 2017), whose incremental machinery is:

  * a per-vertex update threshold: a vertex's dx is applied only when its
    norm reaches m_f_update_thresh (1e-5, :399,1417,1990);
  * fluid relinearization: only the lambda blocks incident to the moved
    vertices are refreshed (:308-318).  Unmoved vertices keep their state,
    so the refresh is exact;
  * the incrementally maintained Schur complement (m_SchurCompl,
    :313-316): only the landmarks the refreshed blocks touch are
    re-eliminated into SC;
  * the batch solver's dogleg trust-region control, each marker's loop
    starting from the batch dogleg's initial radius.  The JAX package keeps
    the radius across markers (m_f_delta, :319); its update
    delta /= max(1/3, 1 - (2 gain - 1)^3) triples it per good iteration
    whatever the step's length, so on the bench scene replayed in 50
    markers it reaches 1.4e12 by the 10th, where a rejected GN step of
    norm 40 is retried unchanged five times while the radius shrinks from
    far above it, and the replay ends 7,000 times above the batch dogleg
    (ROADMAP.md Queue 3).  Restarting the radius gives the JAX package's
    trace where its radius never bound a step and the batch dogleg's chi2
    at the end.

The maintained state is the JAX package's, as tensors on the solver's
device: the planar lambda pieces (pp [Kpp], u [Kpl], ll [Nl], eta_p,
eta_l), the dense reduced camera system SC [Np*Bp]^2 and per edge the
endpoint states of its last refresh (the snapshot).  A refresh evaluates
each edge type's kernel (``Assembler._make_kernel``) at the snapshot and at
the current states of a padded batch of dirty edges and ``index_add_``s the
difference into the maintained arrays, so no per-edge contribution is
cached.  Dirty landmarks are re-eliminated by scatter-built old and new
U / W panels [nred, capL*Bl] and two GEMMs; the dense SC is refactored by
one Cholesky per dogleg iteration (only SC is maintained, not a factor).
Batches are padded to the JAX package's power-of-4 size ladders; a padded
lane repeats a valid index, contributes zero and writes no snapshot.

The engine runs float64 on both devices (config.float64_dtype): the
maintained SC is a sum of deltas that is never re-assembled, and the solve's
gauge ridge (1e-9 relative) and landmark damping (1e-8 relative) are below
float32's resolution.  Host syncs per dogleg iteration: about ten scalar
reads (step norms, dot products, the new chi2) and one read of the moved
vertices' masks.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler, BlockSystem
from slam_plus_plus_tpu_torch.config import SolverSettings, float64_dtype, pin_precision
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.linalg.dense import DenseScatter
from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv
from slam_plus_plus_tpu_torch.marginals.covariance import MarginalsResult
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.solvers.dogleg import INITIAL_TRUST_RADIUS

#: a vertex moves only when its |dx| reaches this (the reference's
#: m_f_update_thresh, NonlinearSolver_Lambda_DL.h:399)
UPDATE_THRESH = 1e-5


def _buckets(n: int, base: int = 256) -> List[int]:
    """Power-of-4 size ladder: [256, 1024, 4096, ...] capped at n."""
    out = []
    b = base
    while b < n:
        out.append(b)
        b *= 4
    out.append(n)
    return out


def _pick_bucket(ladder: List[int], n: int) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def _pad(ids: np.ndarray, cap: int):
    """ids padded to cap with copies of ids[0], and the validity [cap]."""
    valid = np.ones(cap)
    npad = cap - len(ids)
    if npad:
        ids = np.concatenate([ids, np.full(npad, ids[0], dtype=np.int64)])
        valid[cap - npad:] = 0.0
    return ids, valid


def _incident(csr, verts: np.ndarray) -> np.ndarray:
    """The CSR items of the given rows, concatenated in row order."""
    start, items = csr
    lens = start[verts + 1] - start[verts]
    first = np.repeat(start[verts] - np.cumsum(lens) + lens, lens)
    return items[first + np.arange(int(lens.sum()))]


class IncrementalDoglegSolver:
    """Marker-driven incremental BA with fluid relinearization, on one
    device.

    Usage (the incremental_ba_3dv pattern):
        solver = IncrementalDoglegSolver(system, device="cuda")
        chi2, trace = solver.run(marker_steps)     # 0-based step indices
    or advance_to(step) and optimize() per marker.
    """

    #: dogleg iterations per marker, and the GN step norm that ends a
    #: marker's loop (the JAX package's run_incremental_ba defaults)
    MAX_ITERATIONS = 5
    DX_THRESHOLD = 0.01

    def __init__(self, system: GraphSystem, *, device):
        pin_precision()
        self.system = system
        self.delta = INITIAL_TRUST_RADIUS       # where the last marker's loop ended
        self.asm = asm = Assembler(system, device=device,
                                   settings=SolverSettings(edge_layout="flat"),
                                   dtype=float64_dtype(device))
        if asm.Nl == 0 or asm.Kpl == 0:
            raise ValueError("IncrementalDoglegSolver targets Schur-split "
                             "BA problems; use DoglegSolver for pose graphs")
        self.nred = asm.Np * asm.Bp
        self._build_host_structure()
        self._build_device_constants()
        self.stats: Dict[str, float] = dict(solves=0, iters=0, refreshed_edges=0,
                                            refreshed_lms=0)
        self._alpha_l: Optional[float] = None   # fixed at the first marker
        self._M = None                          # the maintained state, from _init_at

    # ------------------------------------------------------------------
    # host symbolic structure
    # ------------------------------------------------------------------

    def _build_host_structure(self) -> None:
        asm = self.asm
        system = self.system

        # replay plan: per inserted edge, its type and index and the active
        # counts per class after it
        seen = set()
        self.steps: List[dict] = []
        nap = nal = 0
        for (ename, li) in system._edge_insert_log:
            for gid in system.edge_stores[ename].vertex_ids[li]:
                if gid not in seen:
                    seen.add(gid)
                    if asm.type_class[system.vertex_directory[gid][0]] == "p":
                        nap += 1
                    else:
                        nal += 1
            self.steps.append(dict(ename=ename, li=li, nap=nap, nal=nal))

        # vertex -> incident (edge type id << 32 | edge index) CSR per class
        heads = {"p": [], "l": []}
        items = {"p": [], "l": []}
        for ti, plan in enumerate(asm.plans):
            eid = (np.int64(ti) << 32) + np.arange(plan.E, dtype=np.int64)
            for k in range(len(plan.slot_types)):
                heads[plan.slot_class[k]].append(np.asarray(plan.slot_cslot[k]))
                items[plan.slot_class[k]].append(eid)

        def csr(cls, n):
            if not heads[cls]:
                return np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int64)
            h = np.concatenate(heads[cls])
            order = np.argsort(h, kind="stable")
            start = np.concatenate([[0], np.cumsum(np.bincount(h, minlength=n))])
            return start.astype(np.int64), np.concatenate(items[cls])[order]

        self._p_inc = csr("p", asm.Np)
        self._l_inc = csr("l", asm.Nl)

        # per-landmark observation table (the SC panel delta): the pl blocks
        # of each landmark in block order, padded to the largest count
        counts = np.bincount(asm.pl_cols, minlength=asm.Nl)
        self.max_obs = int(counts.max())
        order = np.argsort(asm.pl_cols, kind="stable")
        cols = asm.pl_cols[order]
        rank = np.arange(len(order)) - np.concatenate([[0], np.cumsum(counts)])[cols]
        self._obs_tbl_h = np.zeros((asm.Nl, self.max_obs), dtype=np.int64)
        self._obs_rows_h = np.zeros((asm.Nl, self.max_obs), dtype=np.int64)
        self._obs_valid_h = np.zeros((asm.Nl, self.max_obs))
        self._obs_tbl_h[cols, rank] = order
        self._obs_rows_h[cols, rank] = asm.pl_rows[order]
        self._obs_valid_h[cols, rank] = 1.0

        # bucket ladders
        self._edge_ladder = {p.name: _buckets(p.E) for p in asm.plans}
        self._lm_ladder = _buckets(asm.Nl)
        # per edge: added to the maintained state (an old contribution exists)
        self._edge_added = {p.name: np.zeros(p.E, dtype=bool) for p in asm.plans}
        # per vertex: active (its unit pivot removed)
        self._p_active = np.zeros(asm.Np, dtype=bool)
        self._l_active = np.zeros(asm.Nl, dtype=bool)

    def _build_device_constants(self) -> None:
        asm = self.asm
        dev, dt = asm.device, asm.dtype
        self._obs_tbl = torch.as_tensor(self._obs_tbl_h, device=dev)
        self._obs_rows = torch.as_tensor(self._obs_rows_h, device=dev)
        self._obs_valid = torch.as_tensor(self._obs_valid_h, dtype=dt, device=dev)
        # pp pairs into the dense SC: upper blocks and their mirror
        self._sc_pp = DenseScatter(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp, dev)
        self._sc_idx = self._sc_pp.idx.view(asm.Kpp, -1)
        self._sc_idx_t = self._sc_pp.idx_t.view(asm.Kpp, -1)
        self._sc_off = self._sc_pp.off.to(dt)
        self._pl_rows = torch.as_tensor(asm.pl_rows, device=dev)
        self._pl_cols = torch.as_tensor(asm.pl_cols, device=dev)
        self._lambda_mv = LambdaSpmv(asm)

    # ------------------------------------------------------------------
    # the per-type refresh: delta = contribution(now) - contribution(snapshot)
    # ------------------------------------------------------------------

    def _refresh(self, ename: str, eidx, valid, old_mask, new_mask, n_valid: int) -> None:
        """eidx [cap] (padded), valid / old_mask [cap], new_mask [arity, cap]
        on the device; the first n_valid lanes are the valid ones.  Adds
        the edges' contribution at the current states less the one at their
        snapshot (old_mask = 0: none yet) into the maintained arrays, removes
        the unit pivot of each vertex new_mask activates, and moves the
        valid lanes' snapshot to the current states."""
        asm = self.asm
        M = self._M
        plan = asm.plan_of[ename]
        et = EDGE_TYPES[ename]
        data = asm.edge_data[ename]
        kernel = asm._kernels[ename]
        tperm = asm._p_tperm
        z = data["z"][eidx]
        info = data["info"][eidx]
        g_new = tuple(self._states[t][data["slot_local"][k][eidx]]
                      for k, t in enumerate(et.vertex_types))
        g_old = tuple(s[eidx] for s in self._snap[ename])
        _c2n, _hn, gs_n, Hpp_n, Hll_n, Hpl_n = kernel(g_new, z, info)
        _c2o, _ho, gs_o, Hpp_o, Hll_o, Hpl_o = kernel(g_old, z, info)

        vmask = valid[:, None]
        omask = (valid * old_mask)[:, None]
        sc = M["sc"].view(-1)
        for ci, (a, b, _seg, _swp) in enumerate(plan.pp_contribs):
            d = Hpp_n[ci] * vmask - Hpp_o[ci] * omask
            if a == b:
                # activation removes the inactive unit pivot
                cs = data["slot_cslot"][a][eidx]
                d[:, asm._p_diag_cols] -= new_mask[a][:, None] * asm.p_mask_dev[cs]
            else:
                d = torch.where(data["pp_swap"][ci][eidx][:, None], d[:, tperm], d)
            pos = data["pp_seg"][ci][eidx]
            M["pp"].index_add_(0, pos, d)
            # the dense SC's copy of the pp delta, and its mirror
            sc.index_add_(0, self._sc_idx[pos].reshape(-1), d.reshape(-1))
            mirr = d[:, tperm] * self._sc_off[pos][:, None]
            sc.index_add_(0, self._sc_idx_t[pos].reshape(-1), mirr.reshape(-1))

        li = 0
        for k in range(et.arity):
            cs = data["slot_cslot"][k][eidx]
            g = gs_n[k] * vmask - gs_o[k] * omask
            if plan.slot_class[k] == "p":
                M["eta_p"].index_add_(0, cs, g)
            else:
                M["eta_l"].index_add_(0, cs, g)
                d = Hll_n[li] * vmask - Hll_o[li] * omask
                d[:, asm._l_diag_cols] -= new_mask[k][:, None] * asm.l_mask_dev[cs]
                M["ll"].index_add_(0, cs, d)
                li += 1

        for ci in range(len(plan.pl_contribs)):
            M["u"].index_add_(0, data["pl_seg"][ci][eidx],
                              Hpl_n[ci] * vmask - Hpl_o[ci] * omask)

        # snapshot <- current states, for the valid lanes only (a padded
        # lane repeats a valid edge index)
        ev = eidx[:n_valid]
        for s, g in zip(self._snap[ename], g_new):
            s.index_copy_(0, ev, g[:n_valid])

    # ------------------------------------------------------------------
    # the maintained Schur complement
    # ------------------------------------------------------------------

    def _lm_panels(self, u, ll, lm_ids, lvalid, alpha):
        """[capL] landmark ids -> (U panel, W panel) [nred, capL*Bl], each
        landmark's observation blocks in its column slice, W = U C^-1.

        alpha: relative damping added to the landmark diagonal before the
        inversion.  A landmark seen by one camera so far has a rank-2 Hll,
        so its raw inverse is singular; the damping, fixed for the whole
        replay, keeps every C^-1 finite and the panel deltas consistent
        across steps."""
        asm = self.asm
        Bp, Bl, M_ = asm.Bp, asm.Bl, self.max_obs
        dev = u.device
        capL = lm_ids.shape[0]
        ov = self._obs_valid[lm_ids] * lvalid[:, None]                  # [capL, M]
        blocks = u[self._obs_tbl[lm_ids]] * ov[:, :, None]             # [capL, M, Bp*Bl]
        ll_d = ll[lm_ids]
        ll_d[:, asm._l_diag_cols] += alpha
        c_inv = planar.binv(ll_d, Bl)
        w = planar.bmm(blocks.reshape(-1, Bp * Bl), c_inv.repeat_interleave(M_, dim=0),
                       Bp, Bl, Bl).reshape(capL, M_, Bp * Bl)
        # flat panel index of block (camera r, j-th landmark): rows r*Bp..,
        # columns j*Bl..
        rr = (self._obs_rows[lm_ids][:, :, None, None] * Bp
              + torch.arange(Bp, device=dev)[None, None, :, None])
        cc = (torch.arange(capL, device=dev)[:, None, None, None] * Bl
              + torch.arange(Bl, device=dev)[None, None, None, :])
        flat = (rr * (capL * Bl) + cc).reshape(capL, M_, Bp * Bl)
        flat = torch.where(ov[:, :, None] > 0, flat, 0).reshape(-1)
        n = self.nred * capL * Bl
        up = torch.zeros(n, dtype=u.dtype, device=dev).index_add_(
            0, flat, (blocks * ov[:, :, None]).reshape(-1))
        wp = torch.zeros(n, dtype=u.dtype, device=dev).index_add_(
            0, flat, (w * ov[:, :, None]).reshape(-1))
        return up.view(self.nred, capL * Bl), wp.view(self.nred, capL * Bl)

    def _build_sc(self, bs):
        """The dense SC of an assembled system: pp scattered, every
        landmark eliminated at the fixed damping."""
        Nl = self.asm.Nl
        sc = self._sc_pp(bs.pp_blocks)
        up, wp = self._lm_panels(bs.pl_blocks, bs.ll_blocks,
                                 torch.arange(Nl, device=sc.device),
                                 torch.ones(Nl, dtype=sc.dtype, device=sc.device),
                                 self._alpha_l)
        return sc - wp @ up.T

    def _bracketed_reeliminate(self, lms: np.ndarray, do_refresh) -> None:
        """The dirty landmarks' SC panels before the refresh, the refresh
        (which moves u / ll / pp / SC), then the panel-product difference
        into SC: the incrementally maintained Schur complement
        (m_SchurCompl, NonlinearSolver_Lambda_DL.h:313-316).  A brand-new
        landmark's old panel is zero (u = 0 against its unit pivot)."""
        asm = self.asm
        dev, dt = asm.device, asm.dtype
        self.stats["refreshed_lms"] += len(lms)
        old = []
        step = self._lm_ladder[-1]
        for lo in range(0, len(lms), step):
            chunk, lvalid = _pad(lms[lo:lo + step],
                                 _pick_bucket(self._lm_ladder, len(lms[lo:lo + step])))
            ids = torch.as_tensor(chunk, device=dev)
            lv = torch.as_tensor(lvalid, dtype=dt, device=dev)
            up, wp = self._lm_panels(self._M["u"], self._M["ll"], ids, lv, self._alpha_l)
            old.append((ids, lv, up, wp))

        do_refresh()

        for ids, lv, up_old, wp_old in old:
            up_new, wp_new = self._lm_panels(self._M["u"], self._M["ll"], ids, lv,
                                             self._alpha_l)
            self._M["sc"] = self._M["sc"] - (wp_new @ up_new.T - wp_old @ up_old.T)

    def _dispatch_refresh(self, ename: str, els: np.ndarray) -> None:
        """Refresh the given edges of one type in padded batches."""
        asm = self.asm
        dev, dt = asm.device, asm.dtype
        plan = asm.plan_of[ename]
        arity = EDGE_TYPES[ename].arity
        added = self._edge_added[ename]
        ladder = self._edge_ladder[ename]
        self.stats["refreshed_edges"] += len(els)
        for lo in range(0, len(els), ladder[-1]):
            part = els[lo:lo + ladder[-1]]
            chunk, valid = _pad(part, _pick_bucket(ladder, len(part)))
            old_mask = added[chunk].astype(np.float64)
            # a vertex activates the first time an added edge touches it;
            # only its first lane in the batch removes its pivot
            new_mask = np.zeros((arity, len(chunk)))
            for k in range(arity):
                cs = plan.slot_cslot[k][chunk]
                act = self._p_active if plan.slot_class[k] == "p" else self._l_active
                fresh = ~act[cs] & (valid > 0)
                _u, first = np.unique(cs[fresh], return_index=True)
                new_mask[k, np.flatnonzero(fresh)[first]] = 1.0
                act[cs[fresh]] = True
            host = np.concatenate([valid, old_mask, new_mask.reshape(-1)])
            flags = torch.as_tensor(host, dtype=dt).to(dev, non_blocking=True)
            self._refresh(ename, torch.as_tensor(chunk).to(dev, non_blocking=True),
                          flags[:len(chunk)], flags[len(chunk):2 * len(chunk)],
                          flags[2 * len(chunk):].view(arity, len(chunk)), len(part))
            added[chunk] = True

    # ------------------------------------------------------------------
    # maintained-state lifecycle
    # ------------------------------------------------------------------

    def _init_at(self, step_idx: int) -> None:
        """Full assembly at replay position step_idx (the first marker)."""
        asm = self.asm
        st = self.steps[step_idx]
        counts = {n: 0 for n in asm.edge_data}
        for s in self.steps[:step_idx + 1]:
            counts[s["ename"]] += 1
        self._counts = counts
        self._nap, self._nal = st["nap"], st["nal"]
        states = asm.snapshot_states(self.system)
        bs = asm.assemble_active(states, counts, st["nap"], st["nal"])
        # the fixed relative landmark damping (see _lm_panels)
        if self._alpha_l is None:
            self._alpha_l = float(bs.max_hdiag) * 1e-8
        sc = self._build_sc(bs)
        self._snap = {
            plan.name: tuple(states[t][asm.edge_data[plan.name]["slot_local"][k]]
                             for k, t in enumerate(plan.slot_types))
            for plan in asm.plans}
        self._M = dict(sc=sc, pp=bs.pp_blocks, u=bs.pl_blocks, ll=bs.ll_blocks,
                       eta_p=bs.eta_p, eta_l=bs.eta_l)
        self._states = states
        self._max_hdiag = float(bs.max_hdiag)
        for s in self.steps[:step_idx + 1]:
            self._edge_added[s["ename"]][s["li"]] = True
        self._p_active[:st["nap"]] = True
        self._l_active[:st["nal"]] = True
        self._pos = step_idx

    def advance_to(self, step_idx: int) -> None:
        """Activate the edges (position, step_idx]: add them (old_mask = 0)
        into the maintained arrays and re-eliminate the landmarks they
        touch."""
        if self._M is None:
            self._init_at(step_idx)
            return
        asm = self.asm
        pend: Dict[str, List[int]] = {}
        for s in self.steps[self._pos + 1:step_idx + 1]:
            pend.setdefault(s["ename"], []).append(s["li"])
            self._counts[s["ename"]] += 1
        st = self.steps[step_idx]
        self._nap, self._nal = st["nap"], st["nal"]
        lms = []
        for en, els in pend.items():
            plan = asm.plan_of[en]
            for k in range(len(plan.slot_types)):
                if plan.slot_class[k] == "l":
                    lms.append(plan.slot_cslot[k][np.asarray(els)])
        lms = np.unique(np.concatenate(lms)) if lms else np.zeros(0, dtype=np.int64)

        def do_refresh():
            for en, els in pend.items():
                self._dispatch_refresh(en, np.asarray(els, dtype=np.int64))

        self._bracketed_reeliminate(lms, do_refresh)
        self._pos = step_idx

    def _refresh_dirty(self, mp: np.ndarray, ml: np.ndarray) -> None:
        """Fluid relinearization: refresh the added edges incident to the
        moved vertices and re-eliminate the landmarks they touch."""
        asm = self.asm
        moved_p, moved_l = np.flatnonzero(mp), np.flatnonzero(ml)
        if not len(moved_p) and not len(moved_l):
            return
        dirty = np.unique(np.concatenate([_incident(self._p_inc, moved_p),
                                          _incident(self._l_inc, moved_l)]))
        etid = dirty >> 32
        eli = dirty & 0xFFFFFFFF
        sels = {}
        dirty_lms = [moved_l]
        for ti, plan in enumerate(asm.plans):
            sel = eli[etid == ti]
            sel = sel[self._edge_added[plan.name][sel]]
            if not len(sel):
                continue
            sels[plan.name] = sel
            for k in range(len(plan.slot_types)):
                if plan.slot_class[k] == "l":
                    dirty_lms.append(plan.slot_cslot[k][sel])
        lms = np.unique(np.concatenate(dirty_lms))
        lms = lms[self._l_active[lms]]

        def do_refresh():
            for name, sel in sels.items():
                self._dispatch_refresh(name, sel)

        self._bracketed_reeliminate(lms, do_refresh)

    # ------------------------------------------------------------------
    # the solve at the maintained state
    # ------------------------------------------------------------------

    def _solve(self):
        """(dx_p, dx_l): the reduced right-hand side, SC with a 1e-9
        relative gauge ridge, a dense Cholesky and two triangular solves,
        and the landmark back-substitution."""
        asm = self.asm
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        M = self._M
        sc, u, ll, eta_p, eta_l = M["sc"], M["u"], M["ll"], M["eta_p"], M["eta_l"]
        ll_d = ll.clone()
        ll_d[:, asm._l_diag_cols] += self._alpha_l
        c_inv = planar.binv(ll_d, Bl)
        w = planar.bmm(u, c_inv[self._pl_cols], Bp, Bl, Bl)
        w_eta = planar.bmv(w, eta_l[self._pl_cols], Bp, Bl)
        rhs = eta_p - torch.zeros_like(eta_p).index_add_(0, self._pl_rows, w_eta)
        # the BA gauge leaves SC a near-null direction along which the raw
        # GN step explodes; 1e-9-relative damping caps it without moving the
        # well-posed directions (the batch solvers' damped retry, made
        # unconditional)
        sc = sc + (torch.max(torch.diagonal(sc)) * 1e-9) * torch.eye(
            self.nred, dtype=sc.dtype, device=sc.device)
        L, info = torch.linalg.cholesky_ex(sc)
        L = L.masked_fill(info != 0, float("nan"))
        y = torch.linalg.solve_triangular(L, rhs.reshape(self.nred, 1), upper=False)
        dx_p = torch.linalg.solve_triangular(L.mT, y, upper=True).reshape(Np, Bp)
        ut_dx = planar.bmv_At(u, dx_p[self._pl_rows], Bp, Bl)
        rhs_l = eta_l - torch.zeros((Nl, Bl), dtype=u.dtype, device=u.device).index_add_(
            0, self._pl_cols, ut_dx)
        return dx_p, planar.bmv(c_inv, rhs_l, Bl, Bl)

    def _masked_update(self, states, dx_p, dx_l):
        """The thresholded vertex update (the reference's conditional
        PushValuesInGraphSystem, NonlinearSolver_Lambda_DL.h:1417,1990): a
        vertex whose |dx| is below UPDATE_THRESH does not move at all, which
        is what makes the fluid refresh exact.  Returns (states, moved p,
        moved l) with the masks as 0/1 tensors."""
        mp = (torch.sqrt(torch.sum(dx_p * dx_p, dim=1)) >= UPDATE_THRESH).to(dx_p.dtype)
        ml = (torch.sqrt(torch.sum(dx_l * dx_l, dim=1)) >= UPDATE_THRESH).to(dx_l.dtype)
        return self.asm.update(states, dx_p * mp[:, None], dx_l * ml[:, None]), mp, ml

    def _spmv(self, vp, vl):
        """lambda [vp; vl] through the maintained pieces."""
        M = self._M
        zero = M["eta_p"].new_zeros(())
        return self._lambda_mv(BlockSystem(M["pp"], M["u"], M["ll"], M["eta_p"],
                                           M["eta_l"], zero, zero), vp, vl)

    # ------------------------------------------------------------------
    # dogleg at the current replay position
    # ------------------------------------------------------------------

    def _chi2(self, states) -> float:
        return float(self.asm.chi2_active(states, self._counts))

    def optimize(self) -> Tuple[float, int]:
        """The dogleg loop at the current marker; returns (chi2, iterations)."""
        max_iterations, dx_threshold = self.MAX_ITERATIONS, self.DX_THRESHOLD
        delta = INITIAL_TRUST_RADIUS
        states = self._states
        last_error = self._chi2(states)
        n_iters = 0
        it = 0
        while it < max_iterations:
            it += 1
            n_iters += 1
            eta_p, eta_l = self._M["eta_p"], self._M["eta_l"]
            gn_p, gn_l = self._solve()
            gn_ok = bool(np.isfinite(float(torch.sum(gn_p) + torch.sum(gn_l))))
            gn_norm = (float(torch.sqrt(torch.sum(gn_p ** 2) + torch.sum(gn_l ** 2)))
                       if gn_ok else np.inf)
            if gn_ok and gn_norm <= dx_threshold:
                break

            eta_norm = float(torch.sqrt(torch.sum(eta_p ** 2) + torch.sum(eta_l ** 2)))
            if eta_norm < 1e-14:
                break
            le_p, le_l = self._spmv(eta_p, eta_l)
            denom = float(torch.sum(eta_p * le_p) + torch.sum(eta_l * le_l))
            alpha = eta_norm ** 2 / denom if denom > 0 else 0.0

            if gn_ok and gn_norm <= delta:
                dl_p, dl_l = gn_p, gn_l
            elif (not gn_ok) or alpha * eta_norm >= delta:
                scale = delta / eta_norm
                if not gn_ok:
                    scale = min(alpha, scale)
                dl_p, dl_l = eta_p * scale, eta_l * scale
            else:
                a_p, a_l = eta_p * alpha, eta_l * alpha
                b_p, b_l = gn_p - a_p, gn_l - a_l
                bb = float(torch.sum(b_p ** 2) + torch.sum(b_l ** 2))
                c = float(torch.sum(a_p * b_p) + torch.sum(a_l * b_l))
                a2 = (alpha * eta_norm) ** 2
                disc = np.sqrt(c * c + bb * (delta * delta - a2))
                beta = ((-c + disc) / bb if c <= 0 else (delta * delta - a2) / (c + disc))
                dl_p = a_p + beta * b_p
                dl_l = a_l + beta * b_l

            trial, mp, ml = self._masked_update(states, dl_p, dl_l)
            error = self._chi2(trial)
            ld_p, ld_l = self._spmv(dl_p, dl_l)
            pred = float(torch.sum(dl_p * (2.0 * eta_p - ld_p)) +
                         torch.sum(dl_l * (2.0 * eta_l - ld_l)))
            gain = (last_error - error) / pred if pred != 0 else -1.0
            mp_h, ml_h = mp.cpu().numpy() > 0, ml.cpu().numpy() > 0

            delta = delta / max(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
            if gain > 0:
                states = trial
                self._states = states
                last_error = error
                # fluid relinearization of exactly the moved vertices
                self._refresh_dirty(mp_h, ml_h)
            if delta < dx_threshold:
                break

        self.delta = delta
        self.stats["solves"] += 1
        self.stats["iters"] += n_iters
        return last_error, n_iters

    def run(self, marker_steps: List[int]):
        """Replay, optimizing at each marker (0-based step indices); writes
        the states back to the system.  Returns (final chi2, per-marker chi2
        list)."""
        t0 = time.perf_counter()
        trace = []
        for ms in marker_steps:
            self.advance_to(ms)
            trace.append(self.optimize()[0])
        self.asm.writeback_states(self.system, self._states)
        self.elapsed = time.perf_counter() - t0
        return trace[-1] if trace else None, trace

    # ------------------------------------------------------------------
    # Schur-domain marginals of the maintained system (no refactor)
    # ------------------------------------------------------------------

    def marginals(self, alpha: Optional[float] = None) -> MarginalsResult:
        """The camera and landmark block diagonals of Sigma from the
        maintained SC / u / ll (the reference's incremental BA marginals,
        BAMarginals.h:388, driven from the DL loop).

        alpha: gauge damping added to the lambda diagonal, pp and ll, as the
        batch Marginals' gauge_jitter damps (None: 1e-10 x the largest
        Hessian diagonal of the first marker).  The maintained SC holds the
        engine's landmark damping; it is converted in flight:
            SC_d = SC + alpha I + (W - W_d) U^T
        with W_d the coupling products under the damped C.  Then
        Sigma_l = C_d^-1 + W_d^T Sigma_pp W_d per landmark."""
        asm = self.asm
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        if alpha is None:
            alpha = self._max_hdiag * 1e-10
        M = self._M
        sc, u, ll = M["sc"], M["u"], M["ll"]
        dev, dt = sc.device, sc.dtype
        ids = torch.arange(Nl, device=dev)
        ones = torch.ones(Nl, dtype=dt, device=dev)
        # wp: the panel the maintained SC holds; wp_d: the damped one
        up, wp = self._lm_panels(u, ll, ids, ones, self._alpha_l)
        _up, wp_d = self._lm_panels(u, ll, ids, ones, alpha)
        eye = torch.eye(self.nred, dtype=dt, device=dev)
        sc_d = sc + alpha * eye + (wp - wp_d) @ up.T
        L, info = torch.linalg.cholesky_ex(sc_d)
        L = L.masked_fill(info != 0, float("nan"))
        inv_l = torch.linalg.solve_triangular(L, eye, upper=False)
        sigma_pp = inv_l.mT @ inv_l
        p_diag = sigma_pp.reshape(Np, Bp, Np, Bp).diagonal(dim1=0, dim2=2).permute(
            2, 0, 1).reshape(Np, Bp * Bp)
        P = sigma_pp @ wp_d                                       # [nred, Nl*Bl]
        corr = torch.einsum("rli,rlj->lij", wp_d.view(self.nred, Nl, Bl),
                            P.view(self.nred, Nl, Bl))
        ll_d = ll.clone()
        ll_d[:, asm._l_diag_cols] += alpha
        l_diag = planar.binv(ll_d, Bl) + corr.reshape(Nl, Bl * Bl)
        return MarginalsResult(p_diag, l_diag)
