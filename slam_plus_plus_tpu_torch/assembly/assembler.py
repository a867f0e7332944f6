"""Batched lambda/eta assembly (port of slam_plus_plus_tpu/assembly/assembler.py).

Reference analogue: CLambdaOps::{Extend_Lambda, Refresh_Lambda,
Collect_RightHandSide_Vector} with its reduction plans (reference
include/slam/NonlinearSolver_Lambda_Base.h:113,524).

The host symbolic phase is the JAX package's, in numpy, for its one case
here (a mono BA problem of ``edge_p2c`` only): the camera/landmark class
split, class slots, the uniform per-landmark ``[Nl, M]`` edge layout (each
landmark's observations contiguous and padded with zero-information dummy
edges), the pp/pl block keys, the diagonal block ids and the gauge anchor.  Lambda is stored partitioned and planar, as in the JAX package:

    [ H_pp  H_pl ]     H_pp : [Kpp, Bp*Bp] upper pairs
    [  .    H_ll ]     H_pl : [Kpl, Bp*Bl]  (the uniform slots, dummies zero)
                       H_ll : [Nl, Bl*Bl]   block diagonal

The numeric phase covers ``edge_p2c`` through kernel K1
(ops/p2c.py::p2c_edge_terms).  Landmark-side reductions are reshape-sums of
the uniform layout; camera-side reductions are ``index_add_``.  Edge types
without a hand-written path, and layouts other than the uniform one, raise
``NotImplementedError`` (ROADMAP.md Queue 1 items 9 and 11), and so does a
problem too large for the camera/landmark split (item 12).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from slam_plus_plus_tpu_torch.config import default_dtype
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms


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


def _diag_cols(B: int, device) -> torch.Tensor:
    """Planar column ids of a B x B block's diagonal."""
    return torch.arange(B, device=device) * (B + 1)


class Assembler:
    """Per-graph-structure assembly pipeline on one explicit device.

    Build once per graph structure; call :meth:`assemble` with updated
    states each iteration.  States are ``{type name: [n, state_dim]}``
    tensors in this assembler's dtype and device.
    """

    def __init__(self, system: GraphSystem, *, device):
        self.device = torch.device(device)
        self.dtype = default_dtype(self.device)
        self._build_structure(system)
        self._build_device_plan(system)

    # ------------------------------------------------------------------
    # host symbolic phase
    # ------------------------------------------------------------------

    def _build_structure(self, system: GraphSystem) -> None:
        if sorted(system.edge_stores) != ["edge_p2c"]:
            raise NotImplementedError(
                f"edge types {sorted(system.edge_stores)}: only edge_p2c has a "
                "hand-written path; the generic jacfwd path is ROADMAP.md "
                "Queue 1 item 9")
        self.type_names = sorted(system.vertex_stores.keys())
        # split off the landmark class only when the reduced system stays
        # dense-solvable (the JAX package's schur_split="auto")
        pose_dims = sum(
            VERTEX_TYPES[t].tangent_dim * system.vertex_stores[t].n
            for t in self.type_names
            if VERTEX_TYPES[t].schur_class != "landmark")
        if pose_dims > 20000:
            raise NotImplementedError(
                f"{pose_dims} pose dims: the unsplit system needs the MIS-Schur "
                "block Cholesky, ROADMAP.md Queue 1 item 12")
        self.type_class: Dict[str, str] = {
            t: "l" if VERTEX_TYPES[t].schur_class == "landmark" else "p"
            for t in self.type_names}

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
        self.l_order = l_order
        self.Np, self.Nl = len(p_order), len(l_order)
        # one type per class (cam, xyz), so no block has padded tangent dims
        self.Bp, self.Bl = (VERTEX_TYPES[t].tangent_dim for t in ("cam", "xyz"))

        # ---- the edge plan: slot 0 a camera, slot 1 a landmark ----------
        store = system.edge_stores["edge_p2c"]
        E = store.n
        vids = store.vertex_ids[:E]
        cam_local, pt_local = (
            np.array([system.vertex_directory[v][1] for v in vids[:, k]],
                     dtype=np.int64) for k in range(2))
        cam_cslot = self.type_cslot["cam"][cam_local]
        lc = self.type_cslot["xyz"][pt_local]

        # ---- uniform per-landmark edge layout ---------------------------
        # Sort + pad the edges into [Nl, M] groups (dummy edges carry zero
        # information), so every landmark-side reduction is a reshape-sum
        # and the Schur panels index by landmark.  The JAX package takes it
        # when padding inflates the edge count by <= 1.5x (+8192).
        counts = np.bincount(lc, minlength=self.Nl)
        self.M = M = max(int(counts.max()), 1)
        if self.Nl * M > 1.5 * E + 8192:
            raise NotImplementedError(
                f"padding {E} edges to {self.Nl} x {M} slots: the flat edge "
                "layout is ROADMAP.md Queue 1 item 11")
        starts = np.concatenate([[0], np.cumsum(counts)])
        order = np.argsort(lc, kind="stable")
        ranks = np.arange(E) - starts[lc[order]]
        pad_idx = np.full(self.Nl * M, E, dtype=np.int64)
        pad_idx[lc[order] * M + ranks] = order
        self._pad_idx = pad_idx
        # dummies take the slots of edge 0: the same camera as edge 0, so
        # (landmark, camera) pairs can repeat
        self._cam_local = np.concatenate([cam_local, cam_local[:1]])[pad_idx]
        cam_slots = np.concatenate([cam_cslot, cam_cslot[:1]])[pad_idx]

        # pl blocks: the padded slots themselves, no dedup, zero blocks for
        # dummies; the landmark of a slot is positional
        self.pl_rows = cam_slots
        self.pl_cols = np.repeat(np.arange(self.Nl, dtype=np.int64), M)
        self.Kpl = self.Nl * M
        self.pl_uniform = [dict(offset=0, M=M, rows=self.pl_rows, counts=counts)]
        # pp blocks: a slot adds only to its camera's diagonal block, so the
        # pattern is the Np diagonal blocks and a slot's pp block id is its
        # camera slot
        self.pp_rows = self.pp_cols = self.pp_diag_ids = np.arange(
            self.Np, dtype=np.int64)
        self.Kpp = self.Np
        self._cam_slots = cam_slots

        # unary gauge anchor: identity on the first vertex of the first edge
        # (reference CBasicUnaryFactorFactory, include/slam/FlatSystem.h:432-470)
        self.anchor_cslot = None
        if system._edge_insert_log:
            first_et, first_li = system._edge_insert_log[0]
            first_vid = int(system.edge_stores[first_et].vertex_ids[first_li][0])
            tname, li = system.vertex_directory[first_vid]
            self.anchor_cslot = int(self.type_cslot[tname][li])

    # ------------------------------------------------------------------
    # device plan
    # ------------------------------------------------------------------

    def _build_device_plan(self, system: GraphSystem) -> None:
        dev, dt = self.device, self.dtype

        def i64(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)

        store = system.edge_stores["edge_p2c"]
        pad_idx = self._pad_idx
        # dummy edges: zero information, zero measurement
        z = np.concatenate([store.measurements[:store.n], np.zeros((1, 2))])[pad_idx]
        info = np.concatenate([store.informations[:store.n],
                               np.zeros((1, 2, 2))])[pad_idx]
        self.edge_data = dict(
            z_t=torch.as_tensor(z.T.copy(), dtype=dt, device=dev),               # [2, E]
            info_t=torch.as_tensor(info.reshape(-1, 4).T.copy(), dtype=dt, device=dev),  # [4, E]
            cam_local=i64(self._cam_local),
            cam_cslot=i64(self._cam_slots),
        )
        # positional landmark -> type-local row of the xyz store
        self._l_local_map = i64([li for _tn, li in self.l_order])

        self.pp_diag_ids_dev = i64(self.pp_diag_ids)
        self._p_diag_cols = _diag_cols(self.Bp, dev)
        self.state_meta = {t: (self.type_class[t], i64(self.type_cslot[t]))
                           for t in self.type_names}

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

    def _gather(self, states):
        """Per-slot cam [11, E] and point [3, E] states.  The landmark slot is
        positional in the uniform layout: one [Nl] gather, broadcast over M."""
        cam_t = states["cam"].T.contiguous().index_select(1, self.edge_data["cam_local"])
        pts = states["xyz"].index_select(0, self._l_local_map)          # [Nl, 3]
        pt_t = pts.T[:, :, None].expand(3, self.Nl, self.M).reshape(3, -1)
        return cam_t, pt_t

    def _edge_sums(self, states):
        """Raw reductions of the per-edge terms:
        (pp, pl, ll, eta_p, eta_l, chi2, max_hdiag), all planar."""
        d = self.edge_data
        Np, Nl, M, Bp, Bl = self.Np, self.Nl, self.M, self.Bp, self.Bl
        cam_t, pt_t = self._gather(states)
        chi2_e, hdiag_e, g_cam, g_pt, hcc, hcp, hpp = p2c_edge_terms(
            cam_t, pt_t, d["z_t"], d["info_t"])
        chi2 = chi2_e.sum()
        max_hdiag = hdiag_e.amax().clamp_min(0.0)
        # landmark side: reshape-sums over the M slots of each landmark
        eta_l = g_pt.reshape(Bl, Nl, M).sum(-1).T.contiguous()
        ll = hpp.reshape(Bl * Bl, Nl, M).sum(-1).T.contiguous()
        # camera side: index_add_ over each slot's camera / pp block
        eta_p = torch.zeros((Bp, Np), dtype=self.dtype, device=self.device)
        eta_p.index_add_(1, d["cam_cslot"], g_cam)
        pp = torch.zeros((Bp * Bp, self.Kpp), dtype=self.dtype, device=self.device)
        pp.index_add_(1, d["cam_cslot"], hcc)      # pp block id = camera slot
        # the uniform slots are the pl blocks (identity reduction)
        pl = hcp.T.contiguous()
        return (pp.T.contiguous(), pl, ll, eta_p.T.contiguous(), eta_l, chi2,
                max_hdiag)

    def _finalize(self, pp, pl, ll, eta_p, eta_l, chi2, max_hdiag) -> BlockSystem:
        """The gauge anchor: identity added to the anchor camera's diagonal
        block of the freshly reduced pp, in place.  (No block has padded
        tangent dims, so the JAX package's unit pivots for them add zero.)"""
        if self.anchor_cslot is not None:
            aid = int(self.pp_diag_ids[self.anchor_cslot])
            pp[aid, self._p_diag_cols] += 1.0
        return BlockSystem(pp, pl, ll, eta_p, eta_l, chi2, max_hdiag)

    def assemble(self, states) -> BlockSystem:
        return self._finalize(*self._edge_sums(states))

    def chi2(self, states) -> torch.Tensor:
        """Total chi2 through the edge type's own residual (the generic
        quaternion path, as the JAX package's _chi2_impl), not the kernel."""
        cam_t, pt_t = self._gather(states)
        et = EDGE_TYPES["edge_p2c"]
        r = et.residual((cam_t.T, pt_t.T), self.edge_data["z_t"].T)     # [E, 2]
        info = self.edge_data["info_t"].T.reshape(-1, 2, 2)
        return torch.einsum("ei,eij,ej->", r, info, r)

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
