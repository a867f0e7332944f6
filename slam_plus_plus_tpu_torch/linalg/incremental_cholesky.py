"""Incremental (dirty-set) refactorization of the nested MIS-Schur factor.

Port of slam_plus_plus_tpu/linalg/incremental_cholesky.py: the
O(affected)-per-step analogue of the reference FastL's trailing-submatrix
R11 refactorization (reference include/slam/NonlinearSolver_FastL.h:2104-2263,
Refresh_R_IncR11 / Refresh_d_IncR11).  When new-edge Hessian contributions
(omega) land on a few lambda pairs, only the factor blocks REACHABLE from
those pairs through the elimination levels of linalg/block_cholesky.py
change.

The layout is the JAX package's:

  * the factor is stored FLAT, one [rows, B*B] tensor per kind (H: every
    level's pattern blocks and the bottom's; C: pivot inverses; W:
    couplings; P: fill products), each with two trailing rows — DUMMY
    (always zero, the target of padded gathers) and SINK (scratch, the
    target of padded scatters; P's one pad row serves both, as its padded
    lanes write the zeros they read).  No mask is needed anywhere;
  * every level of a dirty step has the SAME capacities (cap_d, cap_e,
    cap_w, cap_p), so each level runs one fixed-shape body: the JAX
    package's ``lax.scan`` is a Python loop over the levels here, and a
    step's shapes never depend on its data;
  * the host reachability walk (numpy, the JAX module's batch walk) packs
    global flat indices into one [L, ROW] buffer per solve point, for many
    solve points in one vectorized pass (``prepare_host_batch``);
  * the many-to-one sums of a step (the omega batch's and each level's
    into the next dirty list) are segmented sums in a fixed order
    (ops/segsum.py), sorted on the device once per step, so a replay
    repeats to the bit on the card.

A step whose walk overflows a capacity has no walk (None) and takes the
full redescent — the reference's Refresh_R_FullR fallback
(NonlinearSolver_FastL.h:2367); the caller (FastLSolver.absorb) decides and
counts it.

The full redescent and the solve run level by level at each level's own
shapes (``BlockCholeskySolver._descend`` and ``solve_with_factor`` over
views of the flat stores), which is the JAX module's bucketed scans
without their padding; both are fixed per plan.  The engine runs float64.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from slam_plus_plus_tpu_torch.linalg.block_cholesky import (
    BlockCholeskyFactor, BlockCholeskySolver, _equilibrated_cholesky)
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.ops.segsum import segment_order, segment_sum
from slam_plus_plus_tpu_torch.utils.timer import span

#: a step's omega delta batch, in contributions: a larger batch (only after
#: a long quiet stretch) takes the full redescent
OMEGA_CAP = 768


class IncrementalCholesky:
    def __init__(self, chol: BlockCholeskySolver, caps: Optional[dict] = None):
        self.chol = chol
        self.plan = chol.plan
        self.B = chol.B
        self.device = chol.device
        self._build_offsets()
        self._set_caps(caps)
        self._build_host_maps()

    # ------------------------------------------------------------------
    # flat store layout
    # ------------------------------------------------------------------

    def _build_offsets(self) -> None:
        plan = self.plan
        levels = plan.levels
        # H: level patterns 0..L-1, then the bottom pattern, then dummy+sink
        self.off_H = np.concatenate([[0], np.cumsum([lv.K for lv in levels])]).astype(np.int64)
        self.KB = len(plan._bottom_idx)          # bottom pattern pairs
        self.KH = int(self.off_H[-1]) + self.KB  # data rows
        self.H_dummy, self.H_sink = self.KH, self.KH + 1
        self.off_H_bottom = int(self.off_H[-1])
        self.K0 = int(self.off_H[1]) if levels else self.KH

        self.off_C = np.concatenate([[0], np.cumsum([lv.n_elim for lv in levels])]).astype(np.int64)
        self.NC = int(self.off_C[-1])
        self.C_dummy, self.C_sink = self.NC, self.NC + 1

        self.off_W = np.concatenate(
            [[0], np.cumsum([len(lv.u_src) for lv in levels])]).astype(np.int64)
        self.NW = int(self.off_W[-1])
        self.W_dummy, self.W_sink = self.NW, self.NW + 1

        self.off_P = np.concatenate([[0], np.cumsum([len(lv.pa) for lv in levels])]).astype(np.int64)
        self.NP = int(self.off_P[-1])
        self.P_dummy = self.NP

        nbB = plan.n_bottom * self.B
        self.nbB = nbB
        self.dense_sink = nbB * nbB     # dense stored flat with 1 sink slot

        def t(x):
            return torch.as_tensor(np.asarray(x), device=self.device)

        # extended bottom scatter plans (row KB = sink)
        sink_row = np.full((1, self.B * self.B), self.dense_sink)
        self._bot_idx_ext = t(np.concatenate([plan._bottom_idx, sink_row]).astype(np.int64))
        self._bot_idx_t_ext = t(np.concatenate([plan._bottom_idx_t, sink_row]).astype(np.int64))
        self._bot_off_ext = t(np.concatenate([plan._bottom_off, [0.0]]))
        self._tperm = t(np.asarray(plan._tperm, dtype=np.int64))

    def _set_caps(self, caps) -> None:
        # uniform per-level capacities: dirty sets stay small and nearly
        # scale-free (a few dozen pairs even at the deepest level on
        # 10k-pose replays, as the JAX package measured)
        caps = caps or {}
        levels = self.plan.levels
        self.cap_d = int(caps.get("d", 384))
        self.cap_e = int(caps.get("e", 192))
        self.cap_w = int(caps.get("w", 384))
        self.cap_p = int(caps.get("p", 768))
        if levels:
            self.cap_e = min(self.cap_e, max(lv.n_elim for lv in levels) + 1)
            self.cap_w = min(self.cap_w, max(len(lv.u_src) for lv in levels) + 1)
            self.cap_p = min(self.cap_p, max(len(lv.pa) for lv in levels) + 1)
        self.cap_d = min(self.cap_d, max(max((lv.K for lv in levels), default=1),
                                         self.KB) + 1)
        # flat per-level slot layout: global indices everywhere; the
        # *_dpos / _epos / _wapos slots localize each read to this step's
        # dirty lists, so the level loop carries only the [cap_d, B*B]
        # running pair deltas and old values are gathered once before it
        slots = [("d_pos", self.cap_d), ("e_diag", self.cap_e),
                 ("e_pos", self.cap_e), ("e_dpos", self.cap_e),
                 ("w_usrc", self.cap_w), ("w_celim", self.cap_w),
                 ("w_pos", self.cap_w), ("w_dpos", self.cap_w),
                 ("w_epos", self.cap_w),
                 ("p_wa", self.cap_p), ("p_wapos", self.cap_p),
                 ("p_ubsrc", self.cap_p), ("p_ub_dpos", self.cap_p),
                 ("p_pos", self.cap_p), ("p_seg", self.cap_p),
                 ("c_pos", self.cap_d), ("c_seg", self.cap_d)]
        off = 0
        self._slots = {}
        for name, size in slots:
            self._slots[name] = (off, off + size)
            off += size
        self._row_len = off

    # ------------------------------------------------------------------
    # host symbolic maps (reachability walk)
    # ------------------------------------------------------------------

    def _build_host_maps(self) -> None:
        self.maps = []
        for lv in self.plan.levels:
            elim_of_pair = np.full(lv.K, -1, dtype=np.int64)
            elim_of_pair[lv.elim_diag_idx] = np.arange(lv.n_elim)
            u_of_pair = np.full(lv.K, -1, dtype=np.int64)
            u_of_pair[lv.u_src] = np.arange(len(lv.u_src))
            carry_dst_of_pair = np.full(lv.K, -1, dtype=np.int64)
            carry_dst_of_pair[lv.carry_src] = lv.carry_dst

            # u grouped by elim (u arrays are already sorted by u_elim)
            cnt = np.bincount(lv.u_elim, minlength=lv.n_elim)
            u_start = np.concatenate([[0], np.cumsum(cnt)])

            # prods grouped by pa and by pb
            order_a = np.argsort(lv.pa, kind="stable")
            a_start = np.concatenate(
                [[0], np.cumsum(np.bincount(lv.pa[order_a], minlength=len(lv.u_src)))]) \
                if len(lv.pa) else np.zeros(len(lv.u_src) + 1, dtype=np.int64)
            order_b = np.argsort(lv.pb, kind="stable")
            b_start = np.concatenate(
                [[0], np.cumsum(np.bincount(lv.pb[order_b], minlength=len(lv.u_src)))]) \
                if len(lv.pb) else np.zeros(len(lv.u_src) + 1, dtype=np.int64)

            self.maps.append(dict(
                elim_of_pair=elim_of_pair, u_of_pair=u_of_pair,
                carry_dst_of_pair=carry_dst_of_pair, u_start=u_start,
                prods_by_pa=order_a, pa_start=a_start,
                prods_by_pb=order_b, pb_start=b_start))

    def _bottom_h(self, D_bot):
        """H rows of the dirty bottom pairs.  Without elimination levels the
        bottom pattern IS level 0, whose rows the omega scatter has already
        updated, so its adds go to the sink (the JAX module adds them a
        second time there)."""
        if not self.plan.levels:
            return np.full(len(D_bot), self.H_sink, dtype=np.int64)
        return self.off_H_bottom + np.asarray(D_bot, dtype=np.int64)

    def dirty_blocks(self, host_packed) -> int:
        """Pattern blocks a step recomputes: the dirty pairs of every level
        and of the bottom, from a walk (prepare_host_batch's); every block
        of the pattern for None (the full redescent)."""
        if host_packed is None:
            return self.KH
        seg, buf, bot_sel, _bot_h = host_packed
        n = int(np.count_nonzero(bot_sel != self.KB))
        if self.plan.levels:
            # level 0's dirty list, which seg indexes, and the deeper levels'
            lo, hi = self._slots["d_pos"]
            n += int(seg.max()) + 1 if len(seg) else 0
            n += int(np.count_nonzero(buf[1:, lo:hi] != self.H_sink))
        return n

    def walk_levels(self, host_packed) -> int:
        """How many elimination levels a walk (prepare_host_batch's) reaches:
        1 + the deepest level at which it refactors an eliminated block, 0
        where it refactors none; every level for None (the full
        redescent)."""
        L = len(self.plan.levels)
        if host_packed is None:
            return L
        lo, hi = self._slots["e_pos"]
        hit = np.flatnonzero((host_packed[1][:L, lo:hi] != self.C_sink).any(axis=1))
        return int(hit[-1]) + 1 if len(hit) else 0

    # ------------------------------------------------------------------
    # host reachability walks: the whole replay's solve schedule is
    # host-static (it depends only on the plan and on which edges are
    # pending at each solve point), so every walk is done in one vectorized
    # numpy pass at construction
    # ------------------------------------------------------------------

    _SHIFT = np.int64(1) << np.int64(42)   # (sid, val) -> combined sort key

    def prepare_host_batch(self, dirty_pos_lists):
        """The reachability walks of many solve points in one vectorized
        pass (dirty_pos_lists: per point, its omega batches' level-0 pair
        positions): per point its walk (seg, buf, bot_sel, bot_h) — the
        level-0 dirty list position of each omega contribution, the packed
        [L, ROW] levels and the bottom's selection and H rows — or None
        where it overflows a capacity.  ``last_batch_per_solve`` keeps each
        point's largest dirty set per kind, for the caller's capacities."""
        S = len(dirty_pos_lists)
        self.last_batch_per_solve = {k: np.zeros(S, dtype=np.int64) for k in ("d", "e", "w", "p")}
        if S == 0:
            return []
        plan = self.plan
        L = len(plan.levels)
        SH = self._SHIFT

        all_pos_l = [np.concatenate(dp) if dp else np.zeros(0, np.int64)
                     for dp in dirty_pos_lists]
        lens = np.array([len(a) for a in all_pos_l])
        over = lens > OMEGA_CAP
        pos_flat = np.concatenate(all_pos_l) if all_pos_l else np.zeros(0, np.int64)
        sid_flat = np.repeat(np.arange(S), lens)

        def dedup(sid, val):
            key = np.sort(sid * SH + val, kind="stable")
            if len(key):
                keep = np.empty(len(key), dtype=bool)
                keep[0] = True
                np.not_equal(key[1:], key[:-1], out=keep[1:])
                key = key[keep]
            return key // SH, key % SH

        def starts_of(sid):
            return np.searchsorted(sid, np.arange(S + 1))

        def expand(sid, ids, start_arr, order=None):
            if not len(ids):
                return (np.zeros(0, np.int64),) * 2
            s, e = start_arr[ids], start_arr[ids + 1]
            ln = e - s
            tot = int(ln.sum())
            flat = np.repeat(s, ln) + (np.arange(tot) - np.repeat(np.cumsum(ln) - ln, ln))
            out_sid = np.repeat(sid, ln)
            return out_sid, (order[flat] if order is not None else flat)

        def locate(h_sid, h_val, h_starts, q_sid, q_val, miss):
            if not len(q_val):
                return np.zeros(0, np.int64)
            if not len(h_val):
                return np.full(len(q_val), miss, dtype=np.int64)
            hk = h_sid * SH + h_val
            qk = q_sid * SH + q_val
            pos = np.searchsorted(hk, qk)
            pc = np.minimum(pos, len(hk) - 1)
            hit = hk[pc] == qk
            return np.where(hit, pc - h_starts[q_sid], miss)

        d_sid, d_val = dedup(sid_flat, pos_flat)
        d0_sid, d0_val = d_sid, d_val
        d0_starts = starts_of(d0_sid)

        # observed per-solve maxima, for the caller's replay-sized capacities
        per_solve = {k: np.zeros(S, dtype=np.int64) for k in ("d", "e", "w", "p")}

        def _upd(name, starts):
            c = starts[1:] - starts[:-1]
            if len(c):
                np.maximum(per_solve[name], c, out=per_solve[name])

        levels_flat = []
        for li, lv in enumerate(plan.levels):
            m = self.maps[li]
            d_starts = starts_of(d_sid)
            _upd("d", d_starts)
            over |= (d_starts[1:] - d_starts[:-1]) > self.cap_d

            e_all = m["elim_of_pair"][d_val] if len(d_val) else d_val
            em = e_all >= 0
            e_sid, e_val = d_sid[em], e_all[em]
            e_starts = starts_of(e_sid)

            u_all = m["u_of_pair"][d_val] if len(d_val) else d_val
            um = u_all >= 0
            uv_sid, uv_val = d_sid[um], u_all[um]

            wf_sid, wf_val = expand(e_sid, e_val, m["u_start"])
            w_sid, w_val = dedup(np.concatenate([uv_sid, wf_sid]),
                                 np.concatenate([uv_val, wf_val]))
            w_starts = starts_of(w_sid)

            pa_sid, pa_val = expand(w_sid, w_val, m["pa_start"], m["prods_by_pa"])
            pb_sid, pb_val = expand(uv_sid, uv_val, m["pb_start"], m["prods_by_pb"])
            p_sid, p_val = dedup(np.concatenate([pa_sid, pb_sid]),
                                 np.concatenate([pa_val, pb_val]))
            p_starts = starts_of(p_sid)

            _upd("e", e_starts)
            _upd("w", w_starts)
            _upd("p", p_starts)
            over |= (e_starts[1:] - e_starts[:-1]) > self.cap_e
            over |= (w_starts[1:] - w_starts[:-1]) > self.cap_w
            over |= (p_starts[1:] - p_starts[:-1]) > self.cap_p

            cd_all = m["carry_dst_of_pair"][d_val] if len(d_val) else d_val
            cm = cd_all >= 0
            c_sid = d_sid[cm]
            c_dst = cd_all[cm]
            c_pos_local = np.flatnonzero(cm) - d_starts[d_sid[cm]]

            pd_val = lv.p_dst[p_val] if len(p_val) else np.zeros(0, np.int64)
            dn_sid, dn_val = dedup(np.concatenate([c_sid, p_sid]),
                                   np.concatenate([c_dst, pd_val]))
            dn_starts = starts_of(dn_sid)
            c_seg = locate(dn_sid, dn_val, dn_starts, c_sid, c_dst, self.cap_d)
            p_seg = locate(dn_sid, dn_val, dn_starts, p_sid, pd_val, self.cap_d)

            levels_flat.append(dict(
                d=(d_sid, d_val, d_starts), e=(e_sid, e_val, e_starts),
                w=(w_sid, w_val, w_starts), p=(p_sid, p_val, p_starts),
                c=(c_sid, c_pos_local, c_seg), p_seg=p_seg))
            d_sid, d_val = dn_sid, dn_val

        d_starts = starts_of(d_sid)
        _upd("d", d_starts)
        over |= (d_starts[1:] - d_starts[:-1]) > self.cap_d
        bot_flat = (d_sid, d_val, d_starts)
        self.last_batch_per_solve = per_solve

        # ---- pack into [S, L, ROW] with flat scatters -------------------
        s = self._slots
        tmpl = np.empty(self._row_len, dtype=np.int32)
        fills = dict(d_pos=self.H_sink, e_diag=self.H_dummy, e_pos=self.C_sink,
                     e_dpos=self.cap_d, w_usrc=self.H_dummy, w_celim=self.C_dummy,
                     w_pos=self.W_sink, w_dpos=self.cap_d, w_epos=self.cap_e,
                     p_wa=self.W_dummy, p_wapos=self.cap_w, p_ubsrc=self.H_dummy,
                     p_ub_dpos=self.cap_d, p_pos=self.P_dummy, p_seg=self.cap_d,
                     c_pos=self.cap_d, c_seg=self.cap_d)
        for name, fill in fills.items():
            lo, hi = s[name]
            tmpl[lo:hi] = fill
        buf_all = np.tile(tmpl, (S, max(L, 1), 1))

        ROW = self._row_len
        flat_view = buf_all.reshape(-1)

        def put(li, name, sid, starts, vals):
            if not len(vals):
                return
            lo, hi = s[name]
            rank = np.arange(len(sid)) - starts[sid]
            # an overflowed solve point exceeds the slot width; it returns
            # None anyway, but its scatter must not spill into the next
            # point's buffer
            keep = rank < (hi - lo)
            if not keep.all():
                sid, rank, vals = sid[keep], rank[keep], np.asarray(vals)[keep]
            idx = (sid * max(L, 1) + li) * ROW + lo + rank
            flat_view[idx] = vals

        for li, lv in enumerate(plan.levels):
            f = levels_flat[li]
            oh, oc, ow, op = self.off_H[li], self.off_C[li], self.off_W[li], self.off_P[li]
            d_sid_l, d_val_l, d_starts_l = f["d"]
            e_sid_l, e_val_l, e_starts_l = f["e"]
            w_sid_l, w_val_l, w_starts_l = f["w"]
            p_sid_l, p_val_l, p_starts_l = f["p"]

            if li > 0:
                put(li, "d_pos", d_sid_l, d_starts_l, oh + d_val_l)

            def dloc(q_sid, pairs):
                if li == 0:
                    return np.full(len(pairs), self.cap_d, dtype=np.int64)
                return locate(d_sid_l, d_val_l, d_starts_l, q_sid, pairs, self.cap_d)

            put(li, "e_diag", e_sid_l, e_starts_l, oh + lv.elim_diag_idx[e_val_l])
            put(li, "e_pos", e_sid_l, e_starts_l, oc + e_val_l)
            put(li, "e_dpos", e_sid_l, e_starts_l, dloc(e_sid_l, lv.elim_diag_idx[e_val_l]))
            usrc = oh + lv.u_src[w_val_l]
            usrc = np.where(lv.u_flip[w_val_l], -usrc - 1, usrc)
            put(li, "w_usrc", w_sid_l, w_starts_l, usrc)
            put(li, "w_celim", w_sid_l, w_starts_l, oc + lv.u_elim[w_val_l])
            put(li, "w_pos", w_sid_l, w_starts_l, ow + w_val_l)
            put(li, "w_dpos", w_sid_l, w_starts_l, dloc(w_sid_l, lv.u_src[w_val_l]))
            put(li, "w_epos", w_sid_l, w_starts_l,
                locate(e_sid_l, e_val_l, e_starts_l, w_sid_l, lv.u_elim[w_val_l], self.cap_e))
            put(li, "p_wa", p_sid_l, p_starts_l, ow + lv.pa[p_val_l])
            put(li, "p_wapos", p_sid_l, p_starts_l,
                locate(w_sid_l, w_val_l, w_starts_l, p_sid_l, lv.pa[p_val_l], self.cap_w))
            ub = oh + lv.u_src[lv.pb[p_val_l]]
            ub = np.where(lv.u_flip[lv.pb[p_val_l]], -ub - 1, ub)
            put(li, "p_ubsrc", p_sid_l, p_starts_l, ub)
            put(li, "p_ub_dpos", p_sid_l, p_starts_l, dloc(p_sid_l, lv.u_src[lv.pb[p_val_l]]))
            ppos = op + p_val_l
            ppos = np.where(lv.p_flip[p_val_l], -ppos - 1, ppos)
            put(li, "p_pos", p_sid_l, p_starts_l, ppos)
            put(li, "p_seg", p_sid_l, p_starts_l, f["p_seg"])
            c_sid_l, c_pos_l, c_seg_l = f["c"]
            c_starts_l = starts_of(c_sid_l)
            put(li, "c_pos", c_sid_l, c_starts_l, c_pos_l)
            put(li, "c_seg", c_sid_l, c_starts_l, c_seg_l)

        b_sid, b_val, b_starts = bot_flat
        bot_sel_all = np.full((S, self.cap_d), self.KB, dtype=np.int32)
        bot_h_all = np.full((S, self.cap_d), self.H_sink, dtype=np.int32)
        if len(b_sid):
            rank = np.arange(len(b_sid)) - b_starts[b_sid]
            keep = rank < self.cap_d   # overflow spill guard (see put)
            bot_sel_all[b_sid[keep], rank[keep]] = b_val[keep]
            bot_h_all[b_sid[keep], rank[keep]] = self._bottom_h(b_val[keep])

        # per-point seg into the level-0 dirty list (duplicates sum)
        seg_flat = locate(d0_sid, d0_val, d0_starts, sid_flat, pos_flat, -1)

        out = []
        off = 0
        for si in range(S):
            n = lens[si]
            out.append(None if over[si] else
                       (seg_flat[off:off + n], buf_all[si], bot_sel_all[si], bot_h_all[si]))
            off += n
        return out

    # ------------------------------------------------------------------
    # full redescent -> flat stores
    # ------------------------------------------------------------------

    def init_stores(self, H0) -> Dict[str, torch.Tensor]:
        """Full redescent from level-0 blocks (PLAN order, [K0, B*B], no
        dummy row) into the flat stores the dirty step updates in place;
        level-0 positions are < K0 of H, where the omega scatter adds."""
        chol, B = self.chol, self.B
        BB = B * B
        sv, outer0 = chol._jacobi_scale(H0)
        dt, dev = H0.dtype, H0.device
        trace = []
        Hb, c_invs, Ws = chol._descend(H0 * outer0, trace)
        H = torch.zeros((self.KH + 2, BB), dtype=dt, device=dev)
        C = torch.zeros((self.NC + 2, BB), dtype=dt, device=dev)
        W = torch.zeros((self.NW + 2, BB), dtype=dt, device=dev)
        P = torch.zeros((self.NP + 1, BB), dtype=dt, device=dev)
        for li, (Hl, prod) in enumerate(trace):
            H[self.off_H[li]:self.off_H[li + 1]] = Hl
            C[self.off_C[li]:self.off_C[li + 1]] = c_invs[li]
            W[self.off_W[li]:self.off_W[li + 1]] = Ws[li]
            if prod is not None:
                P[self.off_P[li]:self.off_P[li + 1]] = prod
        H[self.off_H_bottom:self.KH] = Hb
        dense = chol._bottom_dense(Hb)
        L, s = _equilibrated_cholesky(dense)
        return dict(H=H, C=C, W=W, P=P,
                    dense=torch.cat([dense.reshape(-1), torch.zeros(1, dtype=dt, device=dev)]),
                    L=L, s=s, sv=sv,
                    outer0=torch.cat([outer0, torch.ones((1, BB), dtype=dt, device=dev)]))

    def refactor_full(self, stores) -> Dict[str, torch.Tensor]:
        return self.init_stores(stores["H"][:self.K0] / stores["outer0"][:self.K0])

    # ------------------------------------------------------------------
    # dirty step: refactorization of the reachable blocks + bottom
    # ------------------------------------------------------------------

    def _dirty_scan(self, stores, omega_vals, omega_seg, buf, bot_sel, bot_h):
        """Update the flat stores in place for omega deltas (omega_vals
        [n, B*B] at level-0 dirty list positions omega_seg [n]; the omega
        scatter has already added them to H).  buf [L, ROW], bot_sel and
        bot_h [cap_d] are the packed walk on the device."""
        B = self.B
        BB = B * B
        H, C, W, P = stores["H"], stores["C"], stores["W"], stores["P"]
        dt, dev = H.dtype, H.device
        cap_d = self.cap_d

        # rows summed into cap_d segments in a fixed order (segment cap_d,
        # the padding, drops): the omega batch's, then every level's, each
        # sorted once per step
        d_val = segment_sum(omega_vals, *segment_order(omega_seg, cap_d))
        s = self._slots

        def col(name):
            lo, hi = s[name]
            return buf[:, lo:hi]                       # [L, cap]

        def unflip(idx):
            flip = idx < 0
            return torch.where(flip, -idx - 1, idx), flip

        zero1 = torch.zeros((1, BB), dtype=dt, device=dev)
        L = len(self.plan.levels)
        if L:
            # every OLD value the levels read, gathered once for all levels
            usrc, uflip = unflip(col("w_usrc"))
            ub, ubflip = unflip(col("p_ubsrc"))
            ppos, pflip = unflip(col("p_pos"))
            Hd_old, Uw_old, Upb_old = H[col("e_diag")], H[usrc], H[ub]
            C_old_w, W_old_pa, P_old = C[col("w_celim")], W[col("p_wa")], P[ppos]
            e_dpos, w_dpos, w_epos = col("e_dpos"), col("w_dpos"), col("w_epos")
            p_wapos, p_ub_dpos = col("p_wapos"), col("p_ub_dpos")
            c_pos = col("c_pos")
            seg_perm, seg_off = segment_order(torch.cat([col("c_seg"), col("p_seg")], dim=1),
                                              cap_d)
            w_new_e = (w_epos < self.cap_e)[:, :, None]
            p_new_w = (p_wapos < self.cap_w)[:, :, None]
            d_all, c_all, w_all, p_all = [], [], [], []
            for li in range(L):
                d_ext = torch.cat([d_val, zero1])
                Hd = Hd_old[li] + d_ext[e_dpos[li]]
                c_new = planar.binv(Hd, B)                # [cap_e, B*B]

                Uw = Uw_old[li] + d_ext[w_dpos[li]]
                Uw = torch.where(uflip[li][:, None], planar.btranspose(Uw, B, B), Uw)
                c_ext = torch.cat([c_new, zero1])
                c_eff = torch.where(w_new_e[li], c_ext[w_epos[li]], C_old_w[li])
                W_new = planar.bmm(Uw, c_eff, B, B, B)    # [cap_w, B*B]

                W_ext = torch.cat([W_new, zero1])
                W_eff = torch.where(p_new_w[li], W_ext[p_wapos[li]], W_old_pa[li])
                Upb = Upb_old[li] + d_ext[p_ub_dpos[li]]
                Upb = torch.where(ubflip[li][:, None], planar.btranspose(Upb, B, B), Upb)
                newp = planar.bmm_A_Bt(W_eff, Upb, B, B, B)
                newp = torch.where(pflip[li][:, None], planar.btranspose(newp, B, B), newp)

                vals = torch.cat([d_ext[c_pos[li]], P_old[li] - newp])
                d_all.append(d_val)
                c_all.append(c_new)
                w_all.append(W_new)
                p_all.append(newp)
                d_val = segment_sum(vals, seg_perm[li], seg_off[li])
            # apply every level's updates in one scatter per store (entries
            # belong to exactly one level: no cross-level duplicates; within
            # a level each real entry has its own row and the padding adds
            # zeros to the SINK row, which nothing reads: a fixed result)
            H.index_add_(0, col("d_pos").reshape(-1), torch.stack(d_all).reshape(-1, BB))
            C[col("e_pos").reshape(-1)] = torch.stack(c_all).reshape(-1, BB)
            W[col("w_pos").reshape(-1)] = torch.stack(w_all).reshape(-1, BB)
            P[ppos.reshape(-1)] = torch.stack(p_all).reshape(-1, BB)

        # bottom: apply the deltas to its stored blocks and the dense matrix
        # (one row per real entry, as above)
        H.index_add_(0, bot_h, d_val)
        dense = stores["dense"]
        dense.index_add_(0, self._bot_idx_ext[bot_sel].reshape(-1), d_val.reshape(-1))
        mirr = d_val[:, self._tperm] * self._bot_off_ext[bot_sel][:, None].to(dt)
        dense.index_add_(0, self._bot_idx_t_ext[bot_sel].reshape(-1), mirr.reshape(-1))
        stores["L"], stores["s"] = _equilibrated_cholesky(dense[:-1].reshape(self.nbB, self.nbB))
        return stores

    def packed_len(self, omega_n: int) -> int:
        """Length of :meth:`pack`'s flat int64 layout for an omega batch of
        omega_n contributions: seg [omega_n], buf [L, ROW], bot_sel, bot_h."""
        return omega_n + max(len(self.plan.levels), 1) * self._row_len + 2 * self.cap_d

    def pack(self, host_packed, out: np.ndarray) -> None:
        """The packed walk written into out (int64, :meth:`packed_len` of
        its omega batch long), seg padded to that batch with the dropped
        segment cap_d."""
        seg, buf, bot_sel, bot_h = host_packed
        n = len(out) - buf.size - 2 * self.cap_d
        out[:len(seg)] = seg
        out[len(seg):n] = self.cap_d
        out[n:n + buf.size] = buf.reshape(-1)
        out[n + buf.size:n + buf.size + self.cap_d] = bot_sel
        out[n + buf.size + self.cap_d:] = bot_h

    def unpack(self, flat, omega_n: int):
        """(seg [omega_n], buf [L, ROW], bot_sel, bot_h): views of a packed
        walk that lies on the device."""
        nb = max(len(self.plan.levels), 1) * self._row_len
        return (flat[:omega_n], flat[omega_n:omega_n + nb].view(-1, self._row_len),
                flat[omega_n + nb:omega_n + nb + self.cap_d],
                flat[omega_n + nb + self.cap_d:omega_n + nb + 2 * self.cap_d])

    def upload(self, host_packed, omega_n: int):
        """The packed walk on the device in one host-to-device copy: (seg
        [omega_n], buf [L, ROW], bot_sel, bot_h), int64, seg padded as
        :meth:`pack` pads it."""
        flat = np.empty(self.packed_len(omega_n), dtype=np.int64)
        self.pack(host_packed, flat)
        return self.unpack(torch.from_numpy(flat).to(self.device, non_blocking=True), omega_n)

    # ------------------------------------------------------------------
    # solve (descend + dense bottom + ascend)
    # ------------------------------------------------------------------

    def to_factor(self, stores) -> BlockCholeskyFactor:
        """Per-level views of the flat stores as a BlockCholeskyFactor."""
        L = len(self.plan.levels)
        C, W = stores["C"], stores["W"]
        return BlockCholeskyFactor(
            tuple(C[self.off_C[i]:self.off_C[i + 1]] for i in range(L)),
            tuple(W[self.off_W[i]:self.off_W[i + 1]] for i in range(L)),
            stores["L"], stores["s"], stores["sv"])

    def solve(self, stores, eta0):
        """Solve lambda dx = eta0 with the current flat factor stores; eta0
        [N, B], or k right-hand sides [N, B, k] in one descent and ascent
        (the Woodbury columns of FastL's in-loop marginals and of the online
        engine's fringe)."""
        return self.chol.solve_with_factor(self.to_factor(stores), eta0)

    def solve_with_norm(self, stores, eta0):
        """(dx, |dx|), the norm a device scalar."""
        with span("inc.solve"):
            dx = self.solve(stores, eta0)
            return dx, torch.linalg.vector_norm(dx)
