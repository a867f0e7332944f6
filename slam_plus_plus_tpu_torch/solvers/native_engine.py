"""The C++ incremental replay engine (native/inc_engine.cpp) under FastL.

Port of slam_plus_plus_tpu/solvers/native_engine.py.  The whole replay —
the omega scatter, the delta-propagated refactorization of the MIS levels,
the solve, the push decisions and the activations — runs as one C++ call
over the same symbolic plan the torch engine uses (FastLSolver's
assembler, block-Cholesky plan, replay steps and omega metadata).  It is
the host's engine: it serves SE(2) pose graphs and 2D range-bearing
landmark graphs in float64, with the dirty refresh and without in-loop
marginals, and only where the caller asks for it on the CPU
(``FastLSolver(..., device="cpu", native=True)``, the CLI's ``--native``);
there is no switch that turns it on by itself and no fallback.  The
library is built with g++ at first use (ops/_build.py).
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from slam_plus_plus_tpu_torch.models.types import VERTEX_TYPES
from slam_plus_plus_tpu_torch.ops import _build

#: the vertex and edge types the engine has code for, by its kind numbers
VKIND = {"pose2d": 0, "landmark2d": 1}
EKIND = {"edge_pose2d": 0, "edge_pose_landmark2d": 1}


class UnsupportedReplay(ValueError):
    """The replay asked for is one the C++ engine does not serve."""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("engine")
    i64, vp, dbl = ctypes.c_int64, ctypes.c_void_p, ctypes.c_double
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.spp_inc_create.restype = vp
    lib.spp_inc_create.argtypes = [i64, i64, i64] + [vp] * 14 + [i64, i64] + [vp] * 4 + [i64]
    lib.spp_inc_add_vtype.restype = None
    lib.spp_inc_add_vtype.argtypes = [vp, i64, i64, i64, i64, vp, vp]
    lib.spp_inc_add_etype.restype = None
    lib.spp_inc_add_etype.argtypes = [vp, i64, i64, i64, i64, i64] + [vp] * 8
    lib.spp_inc_set_schedule.restype = None
    lib.spp_inc_set_schedule.argtypes = [vp, i64] + [vp] * 5 + [i64, i64, i64, dbl, i64]
    lib.spp_inc_run.restype = dbl
    lib.spp_inc_run.argtypes = [vp, i64p, i64p, i64p, i64p]
    lib.spp_inc_get_states.restype = None
    lib.spp_inc_get_states.argtypes = [vp, i64, vp]
    lib.spp_inc_destroy.restype = None
    lib.spp_inc_destroy.argtypes = [vp]
    return lib


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _u8(a):
    return np.ascontiguousarray(a, dtype=np.uint8)


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def check_supported(system, *, device, marginals):
    """Raise UnsupportedReplay, naming the reason, unless the engine serves
    this replay: the CPU, no marginals, and only SE(2) / 2D-landmark vertex
    and edge types (it runs float64 with the dirty refresh, as the torch
    engine)."""
    if torch.device(device).type != "cpu":
        raise UnsupportedReplay(f"the C++ engine runs on the host: device {device!r} "
                                f"asked for; use device='cpu'")
    if marginals:
        raise UnsupportedReplay("the C++ engine keeps no in-loop marginals")
    vt = sorted(t for t, s in system.vertex_stores.items() if s.n and t not in VKIND)
    et = sorted(t for t, s in system.edge_stores.items() if s.n and t not in EKIND)
    if vt or et:
        raise UnsupportedReplay(f"the C++ engine serves SE(2) and 2D-landmark graphs; this "
                                f"one has {', '.join(vt + et)}")


class NativeReplay:
    """The replay of a FastLSolver built on the host half (its assembler,
    plan, steps and omega metadata), run by the C++ engine.  The engine
    keeps pointers into the arrays held here, and one of them in a
    process-wide variable, so each run() creates, runs and destroys its own
    engine."""

    def __init__(self, solver):
        asm, plan = solver.asm, solver.chol.plan
        if not plan.levels:
            raise UnsupportedReplay("the C++ engine needs at least one elimination level; "
                                    f"this plan has none ({asm.Np} blocks, all in the bottom)")
        self._solver = solver
        self.B, self.N, self.L = int(asm.Bp), int(asm.Np), len(plan.levels)
        levels = plan.levels

        def cat(f, conv=_i64):
            return conv(np.concatenate([np.asarray(f(lv)).ravel() for lv in levels]))

        self.meta = _i64([[lv.K, lv.K_next, lv.n, lv.n_next, lv.n_elim, len(lv.u_src),
                           len(lv.pa), len(lv.carry_src)] for lv in levels]).reshape(-1)
        self.level_arrays = [
            cat(lambda lv: lv.elim_diag_idx), cat(lambda lv: lv.u_src),
            cat(lambda lv: lv.u_flip, _u8), cat(lambda lv: lv.u_elim),
            cat(lambda lv: lv.pa), cat(lambda lv: lv.pb), cat(lambda lv: lv.p_flip, _u8),
            cat(lambda lv: lv.p_dst), cat(lambda lv: lv.carry_src),
            cat(lambda lv: lv.carry_dst), cat(lambda lv: lv.elim_orig),
            cat(lambda lv: lv.rest_orig), cat(lambda lv: lv.u_rest_next)]
        self.nb = int(plan.n_bottom)
        bot0 = np.asarray(plan._bottom_idx)[:, 0]
        nbB = self.nb * self.B
        self.bot_row = _i64(bot0 // (nbB * self.B))
        self.bot_col = _i64((bot0 % nbB) // self.B)
        self.diag_pos0 = _i64(plan.diag_pos0)
        # the tangent dims of each class slot
        p_mask = np.zeros((self.N, self.B))
        for t in asm.type_names:
            cs = asm.type_cslot[t][:solver.system.vertex_stores[t].n]
            p_mask[cs, :min(self.B, VERTEX_TYPES[t].tangent_dim)] = 1.0
        self.p_mask = _f64(p_mask)
        self.anchor = int(asm.anchor_cslot if asm.anchor_cslot is not None else -1)

        self.vt_names = list(asm.type_names)
        self.vt_cslot = [_i64(asm.type_cslot[t][:solver.system.vertex_stores[t].n])
                         for t in self.vt_names]
        vt_index = {t: i for i, t in enumerate(self.vt_names)}
        self.etypes = []
        for p in asm.plans:
            store = solver.system.edge_stores[p.name]
            E = store.n
            pos, swap = solver._omega_meta[p.name]
            self.etypes.append(dict(
                kind=EKIND[p.name], arity=len(p.slot_types), E=E,
                mdim=store.measurements.shape[1], n_contrib=len(p.pp_contribs),
                arrays=[_i64(np.stack([a[:E] for a in p.slot_local])),
                        _i64(np.stack([a[:E] for a in p.slot_cslot])),
                        _i64([vt_index[t] for t in p.slot_types]),
                        _f64(store.measurements[:E]),
                        _f64(store.informations[:E].reshape(E, -1)),
                        _i64(np.stack([a[:E] for a in pos])),
                        _u8(np.stack([a[:E] for a in swap])),
                        _i64([[a, b] for (a, b, _s, _w) in p.pp_contribs]).reshape(-1)]))
        et_index = {p.name: i for i, p in enumerate(asm.plans)}
        steps = solver.steps
        max_ar = max(len(p.slot_types) for p in asm.plans)
        new_mask = np.zeros((len(steps), max_ar), dtype=np.uint8)
        for i, s in enumerate(steps):
            for (slot, _gid) in s["new_vs"]:
                new_mask[i, slot] = 1
        self.max_arity = max_ar
        self.schedule = [_i64([et_index[s["ename"]] for s in steps]),
                         _i64([s["li"] for s in steps]), _i64([s["n_active"] for s in steps]),
                         _u8([s["closure"] for s in steps]), _u8(new_mask)]

    def run(self):
        """The whole replay from the system's current states, which it
        writes back; returns (chi2, iterations, stats)."""
        t0 = time.perf_counter()
        lib, s = _lib(), self._solver
        ptr = lambda a: a.ctypes.data           # noqa: E731
        h = lib.spp_inc_create(self.B, self.N, self.L, ptr(self.meta),
                               *map(ptr, self.level_arrays), self.nb, len(self.bot_row),
                               ptr(self.bot_row), ptr(self.bot_col), ptr(self.diag_pos0),
                               ptr(self.p_mask), self.anchor)
        try:
            states = []
            for k, t in enumerate(self.vt_names):
                vt, store = VERTEX_TYPES[t], s.system.vertex_stores[t]
                states.append(_f64(store.states[:store.n]))     # the engine copies them
                lib.spp_inc_add_vtype(h, VKIND[t], vt.state_dim, vt.tangent_dim, store.n,
                                      ptr(self.vt_cslot[k]), ptr(states[-1]))
            for et in self.etypes:
                lib.spp_inc_add_etype(h, et["kind"], et["arity"], et["E"], et["mdim"],
                                      et["n_contrib"], *map(ptr, et["arrays"]))
            lib.spp_inc_set_schedule(h, len(s.steps), *map(ptr, self.schedule), self.max_arity,
                                     s.every_n, s.max_iterations, float(s.dx_threshold),
                                     1 if s.onetime_dx else 0)
            it, pushes, full, solves = (ctypes.c_int64() for _ in range(4))
            chi2 = lib.spp_inc_run(h, ctypes.byref(it), ctypes.byref(pushes), ctypes.byref(full),
                                   ctypes.byref(solves))
            for k, t in enumerate(self.vt_names):
                store = s.system.vertex_stores[t]
                out = np.empty((store.n, VERTEX_TYPES[t].state_dim))
                lib.spp_inc_get_states(h, k, ptr(out))
                store.states[:store.n] = out
        finally:
            lib.spp_inc_destroy(h)
        stats = dict(steps=len(s.steps), solve_points=int(solves.value),
                     omega_steps=len(s._sched), pushes=int(pushes.value),
                     full_refactors=int(full.value), iters=int(it.value),
                     elapsed=time.perf_counter() - t0)
        return float(chi2), int(it.value), stats
