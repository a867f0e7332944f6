"""Landmark-sharded bundle adjustment: the block system itself distributed
(port of slam_plus_plus_tpu/parallel/sharded_ba.py).

The distributed assembler (parallel/dist.py) shards only the compute:
every rank holds the whole replicated block system, the first thing that
breaks at venice-real scale.  Here the landmark state is sharded: each rank
holds G = ceil(Nl / n) whole landmark groups of every edge type in the
uniform [Nl, M] layout (``edge_layout="uniform"``, Nl padded to G * n):
their states, their observations, their lambda blocks (ll, eta_l, the pl
blocks) and their rows of the Schur panels.  Every landmark-side reduction
is a local reshape-sum, so no collective runs on the landmark axis.  Per
step the collectives are: one ``all_reduce`` of pp, eta_p and chi2, one
max-reduce of the largest vertex-Hessian diagonal (the damping's source),
and one ``all_reduce`` of the rank's part of the reduced camera system and
of its right-hand side.  The 600 x 600-class reduced solve runs replicated.

Kernels: where the rank's one edge type is ``edge_p2c`` (mono BA), the step
runs K1 (ops/p2c.py::p2c_edge_terms) on its G*M slots, gathered as the
single-process ``Assembler._gather_uniform`` gathers them, and every family
builds its panels through K2 (ops/panel.py::build_panels) from the local
[G, M] blocks, C⁻¹ and the camera ids, several edge types' channels side by
side along M; other edge types take the generic jvp kernels.  The JAX
module's one-hot GEMM gathers are a TPU device (ROADMAP item 23): the port
gathers with ``index_select`` and reduces with ``index_add_``.

Reference analogue: none; the reference is single-process
(LinearSolver_Schur.h:1744 runs its SpDGEMMs on one GPU).  JAX's
``make_lm_mesh`` has no counterpart: the class takes ``group=``.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.assembly.assembler import Assembler, _diag_cols, _transpose_perm
from slam_plus_plus_tpu_torch.config import SolverSettings, default_dtype, pin_precision
from slam_plus_plus_tpu_torch.linalg.dense import DenseScatter, cholesky_solve
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu_torch.ops import planar
from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
from slam_plus_plus_tpu_torch.ops.panel import build_panels
from slam_plus_plus_tpu_torch.parallel.collectives import Collectives


class ShardedBAOptimizer:
    """Damped-GN bundle adjustment with landmark-sharded state, one rank
    per process.

    Requirements: a landmark class, and every landmark edge type observing
    exactly one landmark (the uniform layout; ``Assembler`` raises
    otherwise).  Landmarks of several vertex types share the sharded state
    rows, padded to the widest state, each type updated by its own ⊞."""

    def __init__(self, system, *, device, group=None, dtype=None, damping: float = 1e-3):
        pin_precision()
        self.device = dev = torch.device(device)
        self.dtype = dt = dtype or default_dtype(dev)
        self.comm = Collectives(group)
        n, r = self.n_shards, self.rank = self.comm.size, self.comm.rank
        # the host plan: built on the CPU, each rank moves only its slices
        self.asm = asm = Assembler(system, device="cpu",
                                   settings=SolverSettings(edge_layout="uniform"), dtype=dt)
        self.system = system
        self.damping = damping
        self.l_types = sorted(t for t in asm.type_names if asm.type_class[t] == "l")
        self.l_type = self.l_types[0]
        self.cam_types = [t for t in asm.type_names if asm.type_class[t] == "p"]
        Nl, Np, Bp, Bl = asm.Nl, asm.Np, asm.Bp, asm.Bl
        self.G = G = -(-Nl // n)
        self.Nl_pad = G * n
        self.nred = Np * Bp
        lo, hi = r * G, (r + 1) * G        # this rank's landmark rows (class slots)

        def put(x, dtype=None):
            return torch.as_tensor(np.asarray(x), device=dev, dtype=dtype)

        def rows_of(x, per_row=1, pad=None):
            """This rank's G * per_row rows of x (Nl * per_row rows), padded
            with zeros, or with the row pad."""
            x = np.asarray(x)
            out = np.zeros((G * per_row,) + x.shape[1:], dtype=x.dtype)
            if pad is not None:
                out[:] = pad
            part = x[lo * per_row:min(hi, Nl) * per_row]
            out[:len(part)] = part
            return out

        # ---- sharded landmark state (class-slot order) --------------------
        self.l_state_dim = ldim = max(VERTEX_TYPES[t].state_dim for t in self.l_types)
        xyz = np.zeros((Nl, ldim))
        type_rows = {t: np.zeros(Nl) for t in self.l_types}
        for c, (tn, li) in enumerate(asm.l_order):
            xyz[c, :VERTEX_TYPES[tn].state_dim] = system.vertex_stores[tn].data[li]
            type_rows[tn][c] = 1.0
        self._l_locals = np.array([li for (_t, li) in asm.l_order])
        self._l_typenames = [t for (t, _li) in asm.l_order]
        # pad rows (past Nl) hold landmark 0's state, a valid point for the
        # zero-information dummies observing them, and are never updated
        self.xyz = put(rows_of(xyz, pad=xyz[0]), dt)
        self._type_rows = {t: put(rows_of(m)) > 0 for t, m in type_rows.items()}
        self._l_mask = put(rows_of(asm.l_mask[:Nl]), dt)

        # ---- this rank's G groups of every edge type -----------------------
        self.plan_data = []
        for plan in asm.plans:
            d = asm.edge_data[plan.name]
            M = plan.E // Nl
            lslot = plan.slot_class.index("l")
            e = dict(name=plan.name, M=M, lslot=lslot,
                     l_sd=VERTEX_TYPES[plan.slot_types[lslot]].state_dim,
                     k1=asm.k1, z=put(rows_of(d["z"], M)), info=put(rows_of(d["info"], M)),
                     slot_local=[put(rows_of(x, M)) for x in d["slot_local"]],
                     slot_cslot=[put(rows_of(x, M)) for x in d["slot_cslot"]],
                     pp_seg=[put(rows_of(x, M)) for x in d["pp_seg"]],
                     pp_swap=[put(rows_of(x, M)) for x in d["pp_swap"]],
                     pp_meta=[(a, b) for (a, b, _s, _w) in plan.pp_contribs],
                     pl_slots=[pa for (pa, _lb, _s) in plan.pl_contribs])
            e["rows"] = [e["slot_cslot"][pa].reshape(G, M).to(torch.int32)
                         for pa in e["pl_slots"]]
            if e["k1"]:
                # K1's [d, E] layout
                e["z_t"] = e["z"].T.contiguous()
                e["info_t"] = e["info"].reshape(-1, 4).T.contiguous()
            self.plan_data.append(e)

        # ---- replicated camera side -----------------------------------------
        self._pp_diag_ids = put(asm.pp_diag_ids)
        self._p_mask = put(asm.p_mask, dt)
        self._anchor = asm.anchor_cslot
        self._cslots = {t: put(asm.type_cslot[t]) for t in self.cam_types}
        self._dense_pp = DenseScatter(asm.pp_rows, asm.pp_cols, Np, Bp, dev)
        self._p_diag, self._l_diag = _diag_cols(Bp, dev), _diag_cols(Bl, dev)
        self._p_tperm = torch.as_tensor(_transpose_perm(Bp), device=dev)
        self._l_tperm = torch.as_tensor(_transpose_perm(Bl), device=dev)

    # ---- memory accounting ---------------------------------------------

    def per_device_bytes(self):
        """Estimated device bytes of the solve on one rank: its landmark
        slice (edges, ll, C⁻¹, eta_l, the U and W panel rows) and the
        replicated camera side (SC and its factor, pp, eta_p)."""
        asm = self.asm
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        G, Bl, Bp, nred = self.G, asm.Bl, asm.Bp, self.nred
        sharded = 0
        for e in self.plan_data:
            m = int(np.prod(e["z"].shape[1:]))
            per_edge = (m + 4 + len(e["slot_cslot"]) * 8 +
                        Bp * Bp + Bp * Bl + 2 + Bp)   # z/info/idx + H chunks
            sharded += G * e["M"] * per_edge * itemsize
        sharded += G * (Bl * Bl * 2 + Bl * 2) * itemsize      # ll, c_inv, eta
        sharded += 2 * G * Bl * nred * itemsize               # U, W panels
        replicated = (nred * nred * 2 + asm.Kpp * Bp * Bp + asm.Np * Bp) * itemsize
        return dict(sharded=int(sharded), replicated=int(replicated),
                    total=int(sharded + replicated))

    # ---- the distributed step --------------------------------------------

    def _edge_terms(self, e, cam, xyz):
        """(chi2_e, hdiag_e, g per slot, Hpp per pp pair, Hll, the pl blocks
        [G*M, Bp*Bl] per pl pair) of one edge type's local slots."""
        G, M = self.G, e["M"]
        if e["k1"]:
            cam_t = cam["cam"].T.contiguous().index_select(1, e["slot_local"][0])
            pt_t = xyz.T[:3, :, None].expand(3, G, M).reshape(3, -1)
            chi2_e, hdiag_e, g_cam, g_pt, hcc, hcp, hpp = p2c_edge_terms(
                cam_t, pt_t, e["z_t"], e["info_t"])
            return chi2_e, hdiag_e, (g_cam.T, g_pt.T), (hcc.T,), hpp.T, (hcp.T.contiguous(),)
        et = EDGE_TYPES[e["name"]]
        gathered = []
        for k, t in enumerate(et.vertex_types):
            if k == e["lslot"]:   # positional: one row per group, broadcast over M
                sd = e["l_sd"]
                gathered.append(xyz[:, None, :sd].expand(G, M, sd).reshape(G * M, sd))
            else:
                gathered.append(cam[t].index_select(0, e["slot_local"][k]))
        chi2_e, hdiag_e, gs, Hpp, Hll, Hpl = self.asm._kernels[e["name"]](
            tuple(gathered), e["z"], e["info"])
        return chi2_e, hdiag_e, gs, Hpp, Hll[0], Hpl

    def step(self, cam, xyz):
        """One damped GN step from the replicated camera states cam ({type:
        [n, state_dim]}) and this rank's landmark rows xyz [G, state_dim]:
        (new cam, new xyz, chi2 at cam / xyz, summed over all ranks)."""
        asm, dt, dev = self.asm, self.dtype, self.device
        Np, Bp, Bl, G, nred = asm.Np, asm.Bp, asm.Bl, self.G, self.nred
        pp = torch.zeros((asm.Kpp, Bp * Bp), dtype=dt, device=dev)
        eta_p = torch.zeros((Np, Bp), dtype=dt, device=dev)
        ll = torch.zeros((G, Bl * Bl), dtype=dt, device=dev)
        eta_l = torch.zeros((G, Bl), dtype=dt, device=dev)
        chi2 = torch.zeros((), dtype=dt, device=dev)
        hdiag = torch.zeros((), dtype=dt, device=dev)
        u4s, rows = [], []
        for e in self.plan_data:
            M, lslot = e["M"], e["lslot"]
            chi2_e, hdiag_e, gs, Hpp, Hll, Hpl = self._edge_terms(e, cam, xyz)
            chi2 = chi2 + chi2_e.sum()
            hdiag = torch.maximum(hdiag, hdiag_e.amax())
            for k, g in enumerate(gs):
                if k == lslot:
                    eta_l = eta_l + g.reshape(G, M, Bl).sum(1)
                else:
                    eta_p.index_add_(0, e["slot_cslot"][k], g)
            ll = ll + Hll.reshape(G, M, Bl * Bl).sum(1)
            for ci, (a, b) in enumerate(e["pp_meta"]):
                H = Hpp[ci]
                if a != b:
                    H = torch.where(e["pp_swap"][ci][:, None], H[:, self._p_tperm], H)
                pp.index_add_(0, e["pp_seg"][ci], H)
            for u, rws in zip(Hpl, e["rows"]):
                # K2 reads the Bl x Bp block transposes through their strides
                u4s.append(u.reshape(G, M, Bp, Bl).transpose(2, 3))
                rows.append(rws)
        pp, eta_p, chi2 = self.comm.sum("pp_eta_chi2", pp, eta_p, chi2)
        hdiag = self.comm.max("hdiag", hdiag)

        # finalize (Assembler._finalize) and damp (lm.damp_system)
        ids = self._pp_diag_ids
        diag = pp[ids]
        pp[ids] = 0.5 * (diag + diag[:, self._p_tperm])
        pp[ids[:, None], self._p_diag] += 1.0 - self._p_mask
        if self._anchor is not None:
            pp[int(asm.pp_diag_ids[self._anchor]), self._p_diag] += self._p_mask[self._anchor]
        ll = 0.5 * (ll + ll[:, self._l_tperm])
        ll[:, self._l_diag] += 1.0 - self._l_mask
        alpha = self.damping * hdiag.clamp_min(0.0)
        pp[ids[:, None], self._p_diag] += alpha
        ll[:, self._l_diag] += alpha

        # the sharded Schur complement
        c_inv = planar.binv(ll, Bl)
        if len(u4s) == 1:
            u4, rws = u4s[0], rows[0]
        else:
            u4, rws = torch.cat(u4s, dim=1), torch.cat(rows, dim=1)
        Ut, Wt = build_panels(u4, rws, c_inv, Bl, Bp, Np)
        sc_part, rhs_part = self.comm.sum("sc_rhs", Wt.T @ Ut, Wt.T @ eta_l.reshape(-1))
        dx = cholesky_solve(self._dense_pp(pp) - sc_part, eta_p.reshape(nred) - rhs_part)
        dx_p = dx.reshape(Np, Bp)
        dx_l = planar.bmv(c_inv, eta_l - (Ut @ dx).reshape(G, Bl), Bl, Bl)

        new_cam = {}
        for t in self.cam_types:
            vt = VERTEX_TYPES[t]
            delta = dx_p.index_select(0, self._cslots[t])[:, :vt.tangent_dim]
            new_cam[t] = vt.boxplus(cam[t], delta)
        new_xyz = xyz
        for t in self.l_types:
            vt = VERTEX_TYPES[t]
            upd = vt.boxplus(xyz[:, :vt.state_dim], dx_l[:, :vt.tangent_dim])
            upd = torch.cat([upd, xyz[:, vt.state_dim:]], dim=1)
            new_xyz = torch.where(self._type_rows[t][:, None], upd, new_xyz)
        return new_cam, new_xyz, chi2

    # ---- public ---------------------------------------------------------

    def _cam_snapshot(self):
        return {t: torch.as_tensor(self.system.vertex_stores[t].data, dtype=self.dtype,
                                   device=self.device) for t in self.cam_types}

    def optimize(self, max_iterations: int = 5):
        """Run damped-GN steps from the system's states; returns (chi2
        before the last update, iterations).  Every rank must call it."""
        cam, xyz = self._cam_snapshot(), self.xyz
        chi2 = None
        for _ in range(max_iterations):
            cam, xyz, chi2 = self.step(cam, xyz)
        self.xyz, self._last_cam = xyz, cam
        return float(chi2), max_iterations

    def writeback(self):
        """Write the optimized states into the system (an all-gather of the
        landmark rows: every rank must call it)."""
        xyz = self.comm.gather("writeback", self.xyz)[:self.asm.Nl].double().cpu().numpy()
        for c, li in enumerate(self._l_locals):
            t = self._l_typenames[c]
            self.system.vertex_stores[t].states[li] = xyz[c, :VERTEX_TYPES[t].state_dim]
        for t, arr in getattr(self, "_last_cam", {}).items():
            store = self.system.vertex_stores[t]
            store.states[:store.n] = arr.double().cpu().numpy()
