"""Batched lambda/eta assembly (port of slam_plus_plus_tpu/assembly/assembler.py).

Reference analogue: CLambdaOps::{Extend_Lambda, Refresh_Lambda,
Collect_RightHandSide_Vector} with its reduction plans (reference
include/slam/NonlinearSolver_Lambda_Base.h:113,524).

The host symbolic phase is the JAX package's, in numpy: the class split
(``schur_split``: the landmark class is split off only while the pose dims
stay <= 20000, otherwise one mixed class that the MIS-Schur block Cholesky
eliminates), class slots, padded tangent dims and their masks, the pp block
keys of every edge's pose pairs (stored as upper pairs, a swap flag where an
edge's slots run the other way, deduplicated with ``np.unique``), the pl
keys, the diagonal block ids and the gauge anchor.  Lambda is stored
partitioned and planar, as in the JAX package:

    [ H_pp  H_pl ]     H_pp : [Kpp, Bp*Bp] upper pairs
    [  .    H_ll ]     H_pl : [Kpl, Bp*Bl]
                       H_ll : [Nl, Bl*Bl]   block diagonal

Two numeric paths:

  * a mono BA problem of ``edge_p2c`` only, with the landmark class split
    off, takes the uniform per-landmark ``[Nl, M]`` edge layout (each
    landmark's observations contiguous, padded with zero-information dummy
    edges) and kernel K1 (ops/p2c.py::p2c_edge_terms); landmark-side
    reductions are reshape-sums, camera-side ones ``index_add_``;
  * every other problem takes the generic per-edge kernel: forward-mode
    Jacobians (``torch.func`` jvp, vmapped over the tangent basis) through
    each vertex's ⊞ (the JAX ``_make_kernel``), with IRLS robust weights and
    the expectation mode, reduced by segmented sums in a fixed order
    (ops/segsum.py: one answer per input on the card too), on the flat
    (parse-order) layout, or under ``edge_layout="uniform"`` on every
    landmark edge type sorted and padded into ``[Nl, M]`` groups (the JAX
    package's assembler.py:177-233; the landmark-sharded BA's layout).

The diagonal pp and ll blocks are symmetrized after the reduction, so they
are exactly symmetric whatever order the reductions summed in (a deep
MIS-Schur elimination turns block asymmetry into an O(1) error, as the JAX
package found in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from slam_plus_plus_tpu_torch.config import SolverSettings, default_dtype
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
from slam_plus_plus_tpu_torch.ops.segsum import SegmentSum
from slam_plus_plus_tpu_torch.robust.losses import LOSSES


class BlockSystem(NamedTuple):
    """Partitioned planar block lambda + rhs + chi2 (tensors on one device)."""

    pp_blocks: torch.Tensor  # [Kpp, Bp*Bp] upper pairs
    pl_blocks: torch.Tensor  # [Kpl, Bp*Bl]
    ll_blocks: torch.Tensor  # [Nl, Bl*Bl] block diagonal
    eta_p: torch.Tensor      # [Np, Bp]
    eta_l: torch.Tensor      # [Nl, Bl]
    chi2: torch.Tensor       # scalar
    # max diagonal entry over per-edge vertex Hessian blocks; the reference's
    # LM initial-damping source (NonlinearSolver_Lambda_LM.h:151-198)
    max_hdiag: torch.Tensor  # scalar


@dataclasses.dataclass
class _EdgePlan:
    name: str
    E: int
    slot_types: Tuple[str, ...]
    slot_local: List[np.ndarray]      # [arity] x [E] local index into type store
    slot_cslot: List[np.ndarray]      # [arity] x [E] class-slot index
    slot_class: Tuple[str, ...]       # 'p' | 'l'
    # pp contributions: (slot_a, slot_b, seg_ids[E], swap[E])
    pp_contribs: List[Tuple[int, int, np.ndarray, np.ndarray]]
    # pl contributions: (p_slot, l_slot, seg_ids[E])
    pl_contribs: List[Tuple[int, int, np.ndarray]]


def edge_jacobians(et, states, z, of_expectation: bool = False) -> List[torch.Tensor]:
    """Per-slot Jacobians [E, r, tangent dim] of a batch of E edges: forward
    mode through each vertex's ⊞ at delta = 0, one tangent basis vector per
    ``vmap`` lane, the edges batched inside (the JAX package's vmap of
    jacfwd, with the two maps swapped).  of_expectation: the Jacobian of
    the expectation h, negated to keep the dr/ddelta sign convention (the
    reference differentiates h, not r, SE3_Types.h:265-290)."""
    jacs = []
    for k, t in enumerate(et.vertex_types):
        vt = VERTEX_TYPES[t]

        def fk(delta, k=k, vt=vt):
            st = list(states)
            st[k] = vt.boxplus(st[k], delta)
            return et.expectation(tuple(st)) if of_expectation else et.residual(tuple(st), z)

        E, d = z.shape[0], vt.tangent_dim
        zero = torch.zeros((E, d), dtype=z.dtype, device=z.device)
        basis = torch.eye(d, dtype=z.dtype, device=z.device)[:, None, :].expand(d, E, d)
        cols = torch.func.vmap(lambda t: torch.func.jvp(fk, (zero,), (t,))[1])(basis)  # [d, E, r]
        J = cols.permute(1, 2, 0)                                                    # [E, r, d]
        jacs.append(-J if of_expectation else J)
    return jacs


def robust_loss(et, name: str, settings: SolverSettings):
    """(loss, scale) of a robust edge type: settings.robust_overrides' entry
    for its name, else the "*" entry, else the type's registered pair (the
    JAX assembler.py:460-467); None for a type that is not robust."""
    if not et.robust:
        return None
    overrides = settings.robust_overrides or {}
    loss, scale = overrides.get(name, overrides.get("*", (et.robust_loss, et.robust_scale)))
    return loss, scale


def edge_linearization(et, states, z, info, loss=None):
    """(r, per-slot Jacobians, weighted information) of a batch of edges at
    the states: the residual (the error of the expectation where the type
    is split so, whose Jacobians are then those of h, negated, as the
    reference), and the information scaled by the IRLS weight
    w = loss(|r| / scale) of a robust type, re-evaluated at every
    linearization (SE3_Types.h:128, RobustUtils.h:368-440,
    NonlinearSolver_Lambda.h:455).  loss: (name, scale) from
    ``robust_loss``; None takes the type's registered pair."""
    split = et.expectation is not None
    r = et.error(z, et.expectation(states)) if split else et.residual(states, z)
    jacs = edge_jacobians(et, states, z, of_expectation=split)
    if et.robust:
        name, scale = loss or (et.robust_loss, et.robust_scale)
        w = LOSSES[name](torch.linalg.vector_norm(r, dim=-1) / scale)
        info = info * w[:, None, None]
    return r, jacs, info


def _diag_cols(B: int, device) -> torch.Tensor:
    """Planar column ids of a B x B block's diagonal."""
    return torch.arange(B, device=device) * (B + 1)


def _transpose_perm(B: int) -> List[int]:
    """Planar column permutation that transposes a B x B block."""
    return [i * B + j for j in range(B) for i in range(B)]


def type_classes(system: GraphSystem, settings: SolverSettings) -> Dict[str, str]:
    """Each vertex type's class: "l" where the landmark class is split off
    for Schur elimination, else "p".  schur_split "auto" splits only while
    the pose dims stay <= 20000: past that the mixed MIS elimination
    (landmarks are ideal low-degree candidates) avoids the
    all-landmarks-first fill."""
    names = sorted(system.vertex_stores.keys())
    split = any(VERTEX_TYPES[t].schur_class == "landmark" for t in names)
    if split and settings.schur_split == "off":
        split = False
    elif split and settings.schur_split == "auto":
        pose_dims = sum(VERTEX_TYPES[t].tangent_dim * system.vertex_stores[t].n
                        for t in names if VERTEX_TYPES[t].schur_class != "landmark")
        split = pose_dims <= 20000
    return {t: "l" if (split and VERTEX_TYPES[t].schur_class == "landmark") else "p"
            for t in names}


class Assembler:
    """Per-graph-structure assembly pipeline on one explicit device.

    Build once per graph structure; call :meth:`assemble` with updated
    states each iteration.  States are ``{type name: [n, state_dim]}``
    tensors in this assembler's dtype and device; ``dtype`` None takes
    ``default_dtype(device)``.
    """

    def __init__(self, system: GraphSystem, *, device,
                 settings: Optional[SolverSettings] = None, dtype=None):
        self.device = torch.device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.settings = settings or SolverSettings()
        self._flat_sums = None
        self._build_structure(system)
        self._build_device_plan(system)

    # ------------------------------------------------------------------
    # host symbolic phase
    # ------------------------------------------------------------------

    def _build_structure(self, system: GraphSystem) -> None:
        for name in system.edge_stores:
            if name not in EDGE_TYPES:
                raise NotImplementedError(f"edge type {name} is not ported")
        self.type_names = sorted(system.vertex_stores.keys())
        self.type_class: Dict[str, str] = type_classes(system, self.settings)

        # class slots in global insertion order (the reference's block
        # ordering within each class)
        self.type_cslot: Dict[str, np.ndarray] = {
            t: np.full(system.vertex_stores[t].n, -1, dtype=np.int64)
            for t in self.type_names}
        p_order: List[Tuple[str, int]] = []
        l_order: List[Tuple[str, int]] = []
        for g in system.vertex_order:
            tname, li = system.vertex_directory[g]
            order = p_order if self.type_class[tname] == "p" else l_order
            self.type_cslot[tname][li] = len(order)
            order.append((tname, li))
        self.p_order, self.l_order = p_order, l_order
        self.Np, self.Nl = len(p_order), len(l_order)

        # mixed tangent dims in a class are padded to the class block size
        p_dims = [VERTEX_TYPES[t].tangent_dim for t in self.type_names
                  if self.type_class[t] == "p"]
        l_dims = [VERTEX_TYPES[t].tangent_dim for t in self.type_names
                  if self.type_class[t] == "l"]
        self.Bp = max(p_dims) if p_dims else 1
        self.Bl = max(l_dims) if l_dims else 1
        self.p_mask = np.zeros((max(self.Np, 1), self.Bp))
        for s, (t, _) in enumerate(p_order):
            self.p_mask[s, :VERTEX_TYPES[t].tangent_dim] = 1.0
        self.l_mask = np.zeros((max(self.Nl, 1), self.Bl))
        for s, (t, _) in enumerate(l_order):
            self.l_mask[s, :VERTEX_TYPES[t].tangent_dim] = 1.0

        # ---- per-edge-type slot maps ------------------------------------
        raw_plans = []
        for ename in sorted(system.edge_stores.keys()):
            store = system.edge_stores[ename]
            et = store.etype
            vids = store.vertex_ids[:store.n]
            slot_local, slot_cslot = [], []
            for k in range(et.arity):
                locs = np.array([system.vertex_directory[v][1] for v in vids[:, k]],
                                dtype=np.int64)
                slot_local.append(locs)
                slot_cslot.append(self.type_cslot[et.vertex_types[k]][locs])
            slot_class = tuple(self.type_class[t] for t in et.vertex_types)
            raw_plans.append([ename, et, store.n, slot_local, slot_cslot, slot_class])

        # ---- uniform per-landmark layout ---------------------------------
        # Sort + pad each landmark plan's edges into [Nl, M] groups (dummy
        # edges carry zero information), so every landmark-side reduction is
        # a reshape-sum and each landmark's blocks are contiguous.
        # edge_layout "auto" takes it for a lone edge_p2c plan (mono BA: K1
        # and the uniform Schur solve consume it) while padding inflates the
        # edge count by <= 1.5x (+8192), the JAX package's bound; "uniform"
        # for every plan that observes exactly one landmark, unbounded (the
        # landmark-sharded BA, parallel/sharded_ba.py); "flat" keeps parse
        # order.  Dummies take the other slots of the plan's edge 0, so
        # (landmark, camera) pairs can repeat; the landmark slot is
        # positional, and so is its gather.
        self.pl_uniform = None
        self._pad_maps: Dict[str, np.ndarray] = {}
        lay = self.settings.edge_layout
        l_plans = [rp for rp in raw_plans if "l" in rp[5]]
        if lay == "uniform" and not (self.Nl and all(rp[5].count("l") == 1 for rp in l_plans)):
            raise ValueError("edge_layout 'uniform' needs a landmark class and every landmark "
                             "edge type observing exactly one landmark")
        if lay == "uniform" or (lay == "auto" and [rp[0] for rp in raw_plans] == ["edge_p2c"]
                                and raw_plans[0][5] == ("p", "l")):
            counts = {rp[0]: np.bincount(rp[4][rp[5].index("l")], minlength=self.Nl)
                      for rp in l_plans}
            Ms = {n: max(int(c.max()), 1) for n, c in counts.items()}
            E_old = sum(rp[2] for rp in raw_plans)
            E_new = E_old + sum(self.Nl * Ms[rp[0]] - rp[2] for rp in l_plans)
            if lay == "uniform" or E_new <= 1.5 * E_old + 8192:
                self._uniform_counts = counts
                for rp in l_plans:
                    ename, et, E, slot_local, slot_cslot, slot_class = rp
                    lslot, M = slot_class.index("l"), Ms[ename]
                    lc = slot_cslot[lslot]
                    starts = np.concatenate([[0], np.cumsum(counts[ename])])
                    order = np.argsort(lc, kind="stable")
                    ranks = np.arange(E) - starts[lc[order]]
                    pad_idx = np.full(self.Nl * M, E, dtype=np.int64)
                    pad_idx[lc[order] * M + ranks] = order
                    self._pad_maps[ename] = pad_idx
                    positional = np.repeat(np.arange(self.Nl, dtype=np.int64), M)
                    lmap = np.zeros(self.Nl, dtype=np.int64)
                    for c, (tn, li) in enumerate(l_order):
                        if tn == et.vertex_types[lslot]:
                            lmap[c] = li
                    rp[2] = self.Nl * M
                    rp[3] = [np.concatenate([a, a[:1]])[pad_idx] for a in slot_local]
                    rp[4] = [np.concatenate([a, a[:1]])[pad_idx] for a in slot_cslot]
                    rp[3][lslot], rp[4][lslot] = lmap[positional], positional
        #: the K1 path: a lone edge_p2c plan in the uniform layout
        self.k1 = bool(self._pad_maps) and [rp[0] for rp in raw_plans] == ["edge_p2c"]
        if self.k1:
            self.M = raw_plans[0][2] // self.Nl

        # ---- global pp / pl keys (order defines contribution order) ------
        Np, Nl1 = self.Np, max(self.Nl, 1)
        pp_contrib_keys: List[np.ndarray] = []
        pl_contrib_keys: List[np.ndarray] = []
        pl_contrib_enames: List[str] = []
        plan_meta = []
        for ename, et, E, slot_local, slot_cslot, slot_class in raw_plans:
            pp_list, pl_list = [], []
            for a in range(et.arity):
                for b in range(a, et.arity):
                    ca, cb = slot_class[a], slot_class[b]
                    ia, ib = slot_cslot[a], slot_cslot[b]
                    if ca == "p" and cb == "p":
                        swap = ia > ib
                        keys = np.where(swap, ib * Np + ia, ia * Np + ib)
                        pp_list.append((a, b, keys, swap))
                        pp_contrib_keys.append(keys)
                    elif ca == "l" and cb == "l":
                        if a != b:
                            raise NotImplementedError(
                                f"edge {ename}: landmark-landmark coupling unsupported")
                    else:
                        # orient primary x landmark
                        pa, lb = (a, b) if ca == "p" else (b, a)
                        keys = slot_cslot[pa] * Nl1 + slot_cslot[lb]
                        pl_list.append((pa, lb, keys))
                        pl_contrib_keys.append(keys)
                        pl_contrib_enames.append(ename)
            plan_meta.append((ename, et, E, slot_local, slot_cslot, slot_class,
                              pp_list, pl_list))

        all_pp = (np.concatenate(pp_contrib_keys) if pp_contrib_keys
                  else np.zeros(0, dtype=np.int64))
        uniq_pp, inv_pp = np.unique(all_pp, return_inverse=True)

        if self._pad_maps:
            # uniform layout: the padded slots ARE the pl blocks, in
            # contribution order — no dedup, zero blocks for dummies; one
            # channel per pl contribution
            self.pl_uniform, off = [], 0
            for keys, ename in zip(pl_contrib_keys, pl_contrib_enames):
                self.pl_uniform.append(dict(offset=off, M=len(keys) // self.Nl,
                                            rows=(keys // Nl1).astype(np.int64),
                                            counts=self._uniform_counts[ename]))
                off += len(keys)
            all_pl = np.concatenate(pl_contrib_keys)
            self.pl_rows = (all_pl // Nl1).astype(np.int64)
            self.pl_cols = (all_pl % Nl1).astype(np.int64)
            self.Kpl = off
            inv_pl = np.arange(max(self.Kpl, 1), dtype=np.int64)
        else:
            all_pl = (np.concatenate(pl_contrib_keys) if pl_contrib_keys
                      else np.zeros(0, dtype=np.int64))
            uniq_pl, inv_pl = np.unique(all_pl, return_inverse=True)
            self.pl_rows = (uniq_pl // Nl1).astype(np.int64)
            self.pl_cols = (uniq_pl % Nl1).astype(np.int64)
            self.Kpl = len(uniq_pl)

        # diagonal (p, p) pair ids: every primary vertex gets a diagonal
        # block (vertices with no pp contribution extend the pattern)
        diag_keys = np.arange(Np, dtype=np.int64) * Np + np.arange(Np)
        pos = np.searchsorted(uniq_pp, diag_keys)
        ok = (pos < len(uniq_pp)) & (uniq_pp[np.minimum(pos, len(uniq_pp) - 1)] == diag_keys)
        if not ok.all() and Np:
            uniq_pp = np.sort(np.concatenate([uniq_pp, diag_keys[~ok]]))
            inv_pp = np.searchsorted(uniq_pp, all_pp)
            pos = np.searchsorted(uniq_pp, diag_keys)
        self.pp_rows = (uniq_pp // max(Np, 1)).astype(np.int64)
        self.pp_cols = (uniq_pp % max(Np, 1)).astype(np.int64)
        self.Kpp = len(uniq_pp)
        self.pp_diag_ids = pos.astype(np.int64)

        # distribute the inverse-mapped segment ids back to the plans
        self.plans: List[_EdgePlan] = []
        off_pp = off_pl = 0
        for ename, et, E, slot_local, slot_cslot, slot_class, pp_list, pl_list in plan_meta:
            pp_contribs = []
            for (a, b, _keys, swap) in pp_list:
                pp_contribs.append((a, b, inv_pp[off_pp:off_pp + E].astype(np.int64), swap))
                off_pp += E
            pl_contribs = []
            for (pa, lb, _keys) in pl_list:
                pl_contribs.append((pa, lb, inv_pl[off_pl:off_pl + E].astype(np.int64)))
                off_pl += E
            self.plans.append(_EdgePlan(ename, E, et.vertex_types, slot_local,
                                        slot_cslot, slot_class, pp_contribs, pl_contribs))
        self.plan_of = {plan.name: plan for plan in self.plans}

        # unary gauge anchor: identity on the first vertex of the first edge
        # (reference CBasicUnaryFactorFactory, include/slam/FlatSystem.h:432-470)
        self.anchor_cslot = None
        if system._edge_insert_log:
            first_et, first_li = system._edge_insert_log[0]
            first_vid = int(system.edge_stores[first_et].vertex_ids[first_li][0])
            tname, li = system.vertex_directory[first_vid]
            if self.type_class[tname] == "p":
                self.anchor_cslot = int(self.type_cslot[tname][li])

    # ------------------------------------------------------------------
    # device plan
    # ------------------------------------------------------------------

    def _build_device_plan(self, system: GraphSystem) -> None:
        dev, dt = self.device, self.dtype

        def i64(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)

        def f(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt, device=dev)

        self.edge_data = {}
        for plan in self.plans:
            store = system.edge_stores[plan.name]
            z = store.measurements[:store.n]
            info = store.informations[:store.n]
            pad_idx = self._pad_maps.get(plan.name)
            if pad_idx is not None:
                # dummy edges: zero information, zero measurement
                z = np.concatenate([z, np.zeros_like(z[:1])])[pad_idx]
                info = np.concatenate([info, np.zeros_like(info[:1])])[pad_idx]
            self.edge_data[plan.name] = dict(
                z=f(z), info=f(info),
                slot_local=tuple(i64(x) for x in plan.slot_local),
                slot_cslot=tuple(i64(x) for x in plan.slot_cslot),
                pp_seg=tuple(i64(s) for (_a, _b, s, _w) in plan.pp_contribs),
                pp_swap=tuple(torch.as_tensor(w, device=dev)
                              for (_a, _b, _s, w) in plan.pp_contribs),
                pl_seg=tuple(i64(s) for (_a, _b, s) in plan.pl_contribs),
            )
        if self.k1:
            # K1 takes the [d, E] layout; the landmark slot is positional
            d = self.edge_data["edge_p2c"]
            d["z_t"] = d["z"].T.contiguous()
            d["info_t"] = d["info"].reshape(-1, 4).T.contiguous()
            self._l_local_map = i64([li for _tn, li in self.l_order])

        self.p_mask_dev = f(self.p_mask)
        self.l_mask_dev = f(self.l_mask)
        self.pp_diag_ids_dev = i64(self.pp_diag_ids)
        self._p_diag_cols = _diag_cols(self.Bp, dev)
        self._l_diag_cols = _diag_cols(self.Bl, dev)
        self._p_tperm = torch.as_tensor(_transpose_perm(self.Bp), device=dev)
        self._l_tperm = torch.as_tensor(_transpose_perm(self.Bl), device=dev)
        self.state_meta = {t: (self.type_class[t], i64(self.type_cslot[t]))
                           for t in self.type_names}
        self._kernels: Dict[str, Callable] = {
            plan.name: self._make_kernel(plan) for plan in self.plans
            if not self.k1}

    def _make_kernel(self, plan: _EdgePlan):
        """Per-edge-type kernel over a batch of E edges: the residual, its
        Jacobian per slot and the IRLS-weighted information
        (``edge_linearization``), and the planar JᵀΩJ blocks and gradients
        of the plan."""
        et = EDGE_TYPES[plan.name]
        vts = [VERTEX_TYPES[t] for t in et.vertex_types]
        Bp, Bl = self.Bp, self.Bl
        loss = robust_loss(et, plan.name, self.settings)

        def kernel(states, z, info):
            r, jacs, info_w = edge_linearization(et, states, z, info, loss)
            chi2_e = (r * (info @ r[:, :, None])[:, :, 0]).sum(-1)
            padded = []
            for k, J in enumerate(jacs):
                Bc = Bp if plan.slot_class[k] == "p" else Bl
                padded.append(torch.nn.functional.pad(J, (0, Bc - J.shape[-1])))
            lam_r = info_w @ r[:, :, None]                                    # [E, r, 1]
            JtI = [J.mT @ info_w for J in padded]                             # [E, Bc, r]
            hdiag_e = torch.zeros_like(chi2_e)
            for k, J in enumerate(padded):
                hdiag_e = torch.maximum(hdiag_e, (JtI[k] * J.mT).sum(-1).amax(-1))
            gs = tuple(-(J.mT @ lam_r)[:, :, 0] for J in padded)
            E = z.shape[0]
            Hpp = tuple((JtI[a] @ padded[b]).reshape(E, -1)
                        for (a, b, _s, _w) in plan.pp_contribs)
            Hll = tuple((JtI[k] @ padded[k]).reshape(E, -1)
                        for k in range(len(vts)) if plan.slot_class[k] == "l")
            Hpl = tuple((JtI[pa] @ padded[lb]).reshape(E, -1)
                        for (pa, lb, _s) in plan.pl_contribs)
            return chi2_e, hdiag_e, gs, Hpp, Hll, Hpl

        return kernel

    # ------------------------------------------------------------------
    # states
    # ------------------------------------------------------------------

    def snapshot_states(self, system: GraphSystem) -> Dict[str, torch.Tensor]:
        return self.states_from_numpy(
            {t: system.vertex_stores[t].data for t in self.type_names})

    def writeback_states(self, system: GraphSystem, states) -> None:
        for t, arr in self.states_to_numpy(states).items():
            system.vertex_stores[t].states[:system.vertex_stores[t].n] = arr

    def states_from_numpy(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """{type: numpy [n, state_dim]} -> states on this assembler's device."""
        return {t: torch.tensor(np.asarray(arrays[t]), dtype=self.dtype,
                                device=self.device)
                for t in self.type_names}

    def states_to_numpy(self, states) -> Dict[str, np.ndarray]:
        return {t: states[t].detach().to("cpu", torch.float64).numpy()
                for t in self.type_names}

    # ------------------------------------------------------------------
    # numeric phase
    # ------------------------------------------------------------------

    def _gather_uniform(self, states):
        """K1 inputs: per-slot cam [11, E] and point [3, E] states.  The
        landmark slot is positional: one [Nl] gather, broadcast over M."""
        d = self.edge_data["edge_p2c"]
        cam_t = states["cam"].T.contiguous().index_select(1, d["slot_local"][0])
        pts = states["xyz"].index_select(0, self._l_local_map)          # [Nl, 3]
        pt_t = pts.T[:, :, None].expand(3, self.Nl, self.M).reshape(3, -1)
        return cam_t, pt_t

    def _edge_sums_uniform(self, states):
        """Raw reductions of K1's per-edge terms in the uniform layout."""
        d = self.edge_data["edge_p2c"]
        Np, Nl, M, Bp, Bl = self.Np, self.Nl, self.M, self.Bp, self.Bl
        cam_t, pt_t = self._gather_uniform(states)
        chi2_e, hdiag_e, g_cam, g_pt, hcc, hcp, hpp = p2c_edge_terms(
            cam_t, pt_t, d["z_t"], d["info_t"])
        chi2 = chi2_e.sum()
        max_hdiag = hdiag_e.amax().clamp_min(0.0)
        # landmark side: reshape-sums over the M slots of each landmark
        eta_l = g_pt.reshape(Bl, Nl, M).sum(-1).T.contiguous()
        ll = hpp.reshape(Bl * Bl, Nl, M).sum(-1).T.contiguous()
        # camera side: index_add_ over each slot's camera / pp block
        eta_p = torch.zeros((Bp, Np), dtype=self.dtype, device=self.device)
        eta_p.index_add_(1, d["slot_cslot"][0], g_cam)
        pp = torch.zeros((Bp * Bp, self.Kpp), dtype=self.dtype, device=self.device)
        pp.index_add_(1, d["pp_seg"][0], hcc)
        # the uniform slots are the pl blocks (identity reduction)
        pl = hcp.T.contiguous()
        return (pp.T.contiguous(), pl, ll, eta_p.T.contiguous(), eta_l, chi2,
                max_hdiag)

    def _flat_sum_plans(self) -> Dict[str, SegmentSum]:
        """Per output block array, one segmented sum (ops/segsum.py) of
        every plan's slot or contribution terms, in the order
        ``_edge_sums_flat`` lists them, over this assembler's edge_data;
        built at first use (a masked copy of edge_data shares its index
        arrays)."""
        if self._flat_sums is None:
            dst = {k: [] for k in ("pp", "pl", "ll", "eta_p", "eta_l")}
            for plan in self.plans:
                data = self.edge_data[plan.name]
                for k in range(len(plan.slot_types)):
                    cs = data["slot_cslot"][k].cpu().numpy()
                    dst["eta_p" if plan.slot_class[k] == "p" else "eta_l"].append(cs)
                    if plan.slot_class[k] == "l":
                        dst["ll"].append(cs)
                dst["pp"] += [seg.cpu().numpy() for seg in data["pp_seg"]]
                dst["pl"] += [seg.cpu().numpy() for seg in data["pl_seg"]]
            Np, Nl = max(self.Np, 1), max(self.Nl, 1)
            n = dict(pp=self.Kpp, pl=max(self.Kpl, 1), ll=Nl, eta_p=Np, eta_l=Nl)
            self._flat_sums = {
                k: SegmentSum(np.concatenate(v) if v else np.zeros(0, dtype=np.int64), n[k],
                              self.device)
                for k, v in dst.items()}
        return self._flat_sums

    def _edge_sums_flat(self, states, edge_data=None):
        """Raw reductions of the generic kernels' per-edge terms onto the
        class slots and the pp/pl block ids, swapped pp pairs transposed
        first: one segmented sum per output, every term in a fixed order
        (on the CPU the order of a chain of ``index_add_``).  edge_data:
        this assembler's, or a masked copy."""
        edge_data = edge_data or self.edge_data
        dt, dev = self.dtype, self.device
        Bp, Bl = self.Bp, self.Bl
        Np, Nl = max(self.Np, 1), max(self.Nl, 1)
        terms = {k: [] for k in ("pp", "pl", "ll", "eta_p", "eta_l")}
        chi2 = torch.zeros((), dtype=dt, device=dev)
        max_hdiag = torch.zeros((), dtype=dt, device=dev)
        for plan in self.plans:
            data = edge_data[plan.name]
            gathered = tuple(states[t].index_select(0, data["slot_local"][k])
                             for k, t in enumerate(plan.slot_types))
            chi2_e, hdiag_e, gs, Hpp, Hll, Hpl = self._kernels[plan.name](
                gathered, data["z"], data["info"])
            chi2 = chi2 + chi2_e.sum()
            max_hdiag = torch.maximum(max_hdiag, hdiag_e.amax())
            li = 0
            for k in range(len(plan.slot_types)):
                if plan.slot_class[k] == "p":
                    terms["eta_p"].append(gs[k])
                else:
                    terms["eta_l"].append(gs[k])
                    terms["ll"].append(Hll[li])
                    li += 1
            for ci, (a, b, _s, _w) in enumerate(plan.pp_contribs):
                H = Hpp[ci]
                if a != b:
                    swap = data["pp_swap"][ci]
                    H = torch.where(swap[:, None], H[:, self._p_tperm], H)
                terms["pp"].append(H)
            terms["pl"] += list(Hpl)
        sums = self._flat_sum_plans()
        shapes = dict(pp=(self.Kpp, Bp * Bp), pl=(max(self.Kpl, 1), Bp * Bl),
                      ll=(Nl, Bl * Bl), eta_p=(Np, Bp), eta_l=(Nl, Bl))
        out = {k: (sums[k](torch.cat(v)) if v else
                   torch.zeros(shapes[k], dtype=dt, device=dev))
               for k, v in terms.items()}
        return (out["pp"], out["pl"], out["ll"], out["eta_p"], out["eta_l"], chi2,
                max_hdiag)

    def _edge_sums(self, states):
        """Raw reductions (pp, pl, ll, eta_p, eta_l, chi2, max_hdiag), all
        planar."""
        if self.k1:
            return self._edge_sums_uniform(states)
        return self._edge_sums_flat(states)

    def _finalize(self, pp, pl, ll, eta_p, eta_l, chi2, max_hdiag) -> BlockSystem:
        """Symmetrize the diagonal blocks, put unit pivots on padded tangent
        dims (keeps lambda SPD and their dx exactly 0) and add the gauge
        anchor (identity on the first edge's first vertex, masked to its
        real dims) — in place on the freshly reduced blocks."""
        ids = self.pp_diag_ids_dev
        diag = pp.index_select(0, ids)
        pp[ids] = 0.5 * (diag + diag[:, self._p_tperm])
        pp[ids[:, None], self._p_diag_cols] += 1.0 - self.p_mask_dev
        if self.Nl:
            ll.copy_(0.5 * (ll + ll[:, self._l_tperm]))
            ll[:, self._l_diag_cols] += 1.0 - self.l_mask_dev
        if self.anchor_cslot is not None:
            aid = int(self.pp_diag_ids[self.anchor_cslot])
            pp[aid, self._p_diag_cols] += self.p_mask_dev[self.anchor_cslot]
        return BlockSystem(pp, pl, ll, eta_p, eta_l, chi2, max_hdiag)

    def assemble(self, states) -> BlockSystem:
        return self._finalize(*self._edge_sums(states))

    def chi2(self, states, edge_data=None) -> torch.Tensor:
        """Total chi2 through each edge type's own batched residual, or its
        error of the expectation where the type is split so (for edge_p2c
        the generic quaternion path, not K1)."""
        edge_data = edge_data or self.edge_data
        chi2 = torch.zeros((), dtype=self.dtype, device=self.device)
        for plan in self.plans:
            data = edge_data[plan.name]
            gathered = tuple(states[t].index_select(0, data["slot_local"][k])
                             for k, t in enumerate(plan.slot_types))
            et = EDGE_TYPES[plan.name]
            r = (et.error(data["z"], et.expectation(gathered)) if et.expectation is not None
                 else et.residual(gathered, data["z"]))
            chi2 = chi2 + torch.einsum("ei,eij,ej->", r, data["info"], r)
        return chi2

    # ---- active-prefix (incremental) variants -------------------------
    #
    # An incremental replay runs against the FULL structure with
    # active-count masking (the JAX package's design): edges beyond the
    # active prefix of each type carry zero information, inactive vertices
    # a unit diagonal pivot (dx = 0), so every replay step reuses the one
    # plan (the reference's Extend_Lambda, NonlinearSolver_Lambda_Base.h).

    def _refuse_uniform(self):
        if self.pl_uniform is not None:
            raise RuntimeError("active-prefix masking needs parse order; construct the "
                               "Assembler with SolverSettings(edge_layout='flat')")

    def _mask_edge_data(self, counts: Dict[str, int]):
        """edge_data with the information of each type's edges past
        counts[type] (its active prefix) zeroed."""
        self._refuse_uniform()
        masked = {}
        for plan in self.plans:
            d = dict(self.edge_data[plan.name])
            mask = torch.arange(plan.E, device=self.device) < counts[plan.name]
            d["info"] = d["info"] * mask.to(self.dtype)[:, None, None]
            masked[plan.name] = d
        return masked

    def assemble_active(self, states, counts: Dict[str, int], n_active_p: int,
                        n_active_l: int) -> BlockSystem:
        """The block system of the active prefix: masked edges, and a unit
        pivot (on the real tangent dims) on every class slot at or past
        n_active_p / n_active_l."""
        bs = self._finalize(*self._edge_sums_flat(states, self._mask_edge_data(counts)))
        pp, ll = bs.pp_blocks, bs.ll_blocks
        inactive_p = (torch.arange(max(self.Np, 1), device=self.device) >= n_active_p)
        pp[self.pp_diag_ids_dev[:, None], self._p_diag_cols] += (
            inactive_p.to(self.dtype)[:, None] * self.p_mask_dev)
        if self.Nl:
            inactive_l = torch.arange(self.Nl, device=self.device) >= n_active_l
            ll[:, self._l_diag_cols] += inactive_l.to(self.dtype)[:, None] * self.l_mask_dev
        return bs

    def chi2_active(self, states, counts: Dict[str, int]) -> torch.Tensor:
        """chi2 over each type's active prefix of edges."""
        return self.chi2(states, self._mask_edge_data(counts))

    def place_vertex(self, states, ename: str, slot: int, eidx: int):
        """Place vertex `slot` of edge eidx of type ename from that edge at
        the current states, in place (EdgeType.device_initializer; a type
        without one keeps the parsed state).  One vertex per call: the next
        may be placed from this one's fresh state."""
        et = EDGE_TYPES[ename]
        if et.device_initializer is None:
            return states
        plan = self.plan_of[ename]
        gathered = tuple(states[t][int(plan.slot_local[k][eidx])][None]
                         for k, t in enumerate(et.vertex_types))
        z = self.edge_data[ename]["z"][eidx][None]
        li = int(plan.slot_local[slot][eidx])
        states[et.vertex_types[slot]][li] = et.device_initializer(gathered, z, slot)[0]
        return states

    def update(self, states, dx_p, dx_l):
        """x ⊞ dx per vertex type (the JAX _update_impl): dx_p [Np, Bp],
        dx_l [Nl, Bl] in class-slot order."""
        new_states = {}
        for t in self.type_names:
            vt = VERTEX_TYPES[t]
            cls, cslot = self.state_meta[t]
            dx = dx_p if cls == "p" else dx_l
            delta = dx.index_select(0, cslot)[:, :vt.tangent_dim]
            new_states[t] = vt.boxplus(states[t], delta)
        return new_states
