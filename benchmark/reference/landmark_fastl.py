"""Plain reference of an incremental 2D landmark-SLAM replay with FastL's
semantics (SLAM++'s CNonlinearSolver_FastL, NonlinearSolver_FastL.h, run as
the CLI's ``-nsp N -fL``) over mixed vertices: poses (x, y, theta) and 2D
landmarks (x, y).

Edges arrive in file order: odometry (SE(2), ``EDGE2``) and range-bearing
sightings (``LANDMARK2:XY``; SE2_Types.h).  A sighting's XY measurement is
converted to range and bearing with identity information, as SLAM++'s
t_ToPolar does; its residual is [z_r - max(|d|, 1e-5), wrap(z_b -
(atan2(d) - theta))], d the landmark less the pose's position.  A vertex is
new when an edge first names it: the first edge's first vertex at the
origin, a pose at its odometry's other end composed with the measurement, a
landmark at the pose composed with the polar offset.  Each vertex takes 3
or 2 rows of Lambda, in order of first appearance.

The solve schedule is ``pose_fastl``'s: an edge closes a loop when its
older vertex lies more than its arity behind the newest; every time N new
vertices have arrived (a solve point) and a loop closure is outstanding,
up to ``max_iterations`` Gauss-Newton steps at the current linearization,
each taken when longer than ``dx_threshold`` (and finite, and under 1e5),
which linearizes anew, else discarded (break-before-push); the one-time dx
at the end; the first solve point only starts the system; the gauge anchor
I on the first edge's first vertex; a dense Cholesky, whose failure gives a
non-finite step.  Those parts are copied from ``pose_fastl``, not shared,
so that ``pose_fastl``, the reference of the SE(2) cells, stays as it was
measured.  Every matrix product goes through ``Precision.mm``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import Precision

#: a step at least this long is refused outright (a near-singular system)
STEP_REFUSED = 1e5
#: the least range of a sighting's residual (SLAM++'s |r| >= 1e-5)
MIN_RANGE = 1e-5
POSE, LANDMARK = 3, 2


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def to_polar(xy: np.ndarray) -> np.ndarray:
    """[k, 2] XY offsets as [k, 2] range and bearing (t_ToPolar)."""
    return np.stack([np.hypot(xy[:, 0], xy[:, 1]), np.arctan2(xy[:, 1], xy[:, 0])], 1)


class _Graph:
    def __init__(self, scene, P: Precision, device):
        self.P, dt = P, P.dtype
        ids = np.stack([scene.edge_i, scene.edge_j], 1)
        # vertex order: first appearance, slot order within an edge
        _, first = np.unique(ids.reshape(-1), return_index=True)
        order = ids.reshape(-1)[np.sort(first)]
        self.ids = order
        slot = {int(g): k for k, g in enumerate(order)}
        self.a = np.array([slot[int(g)] for g in scene.edge_i])
        self.b = np.array([slot[int(g)] for g in scene.edge_j])
        self.odo = np.asarray(scene.odometry, dtype=bool)
        is_lm = np.zeros(len(order), dtype=bool)
        is_lm[self.b[~self.odo]] = True
        self.is_lm = is_lm
        self.dim = np.where(is_lm, LANDMARK, POSE)
        self.off = np.concatenate([[0], np.cumsum(self.dim)])
        z = np.asarray(scene.z, dtype=np.float64).copy()
        z[~self.odo, :2] = to_polar(z[~self.odo, :2])
        self.z = torch.as_tensor(z, device=device, dtype=dt)
        self.info = torch.as_tensor(scene.info, device=device, dtype=dt)
        # per edge kind, the edges' indices in file order
        self.kinds = {k: np.flatnonzero(self.odo == (k == "odo")) for k in ("odo", "obs")}
        self.dev = {k: torch.as_tensor(v, device=device) for k, v in self.kinds.items()}
        self.a_dev = torch.as_tensor(self.a, device=device)
        self.b_dev = torch.as_tensor(self.b, device=device)
        self.off_dev = torch.as_tensor(self.off[:-1], device=device)
        # states: every vertex in 3 columns (a landmark's third stays 0)
        self.x = torch.zeros((len(order), 3), device=device, dtype=dt)
        self.anchor = int(self.a[0])
        self.device = device

    def place(self, k: int, slot: int):
        """Place vertex `slot` of edge k from that edge."""
        a, b = int(self.a[k]), int(self.b[k])
        if slot == 0:
            self.x[a] = 0.0
            return
        xa, z = self.x[a], self.z[k]
        if self.odo[k]:
            c, s = torch.cos(xa[2]), torch.sin(xa[2])
            self.x[b] = torch.stack([xa[0] + c * z[0] - s * z[1], xa[1] + s * z[0] + c * z[1],
                                     _wrap(xa[2] + z[2])])
        else:
            ang = xa[2] + z[1]
            self.x[b] = torch.stack([xa[0] + z[0] * torch.cos(ang), xa[1] + z[0] * torch.sin(ang),
                                     torch.zeros_like(ang)])

    def _edges(self, kind: str, m: int):
        """The first m edges' indices of a kind."""
        idx = self.dev[kind]
        return idx[:int(np.searchsorted(self.kinds[kind], m))]

    def residuals(self, x, m: int):
        """Per kind, over the first m edges: (edge indices, r [e, d], Ja [e,
        d, da], Jb [e, d, db]), J = -dr/dx... as pose_fastl: J = -dh/dx."""
        out = {}
        e = self._edges("odo", m)
        xa, xb, z = x[self.a_dev[e]], x[self.b_dev[e]], self.z[e]
        c, s = torch.cos(xa[:, 2]), torch.sin(xa[:, 2])
        dx, dy = xb[:, 0] - xa[:, 0], xb[:, 1] - xa[:, 1]
        h = torch.stack([c * dx + s * dy, -s * dx + c * dy, _wrap(xb[:, 2] - xa[:, 2])], -1)
        r = z - h
        r = torch.cat([r[:, :2], _wrap(r[:, 2:])], -1)
        o, l = torch.zeros_like(c), torch.ones_like(c)
        Ja = -torch.stack([-c, -s, -s * dx + c * dy, s, -c, -c * dx - s * dy, o, o, -l],
                          -1).reshape(-1, 3, 3)
        Jb = -torch.stack([c, s, o, -s, c, o, o, o, l], -1).reshape(-1, 3, 3)
        out["odo"] = (e, r, Ja, Jb)

        e = self._edges("obs", m)
        xa, xb, z = x[self.a_dev[e]], x[self.b_dev[e]], self.z[e]
        dx, dy = xb[:, 0] - xa[:, 0], xb[:, 1] - xa[:, 1]
        q = dx * dx + dy * dy
        dist = torch.sqrt(q)
        far = dist > MIN_RANGE
        rho = torch.where(far, dist, torch.full_like(dist, MIN_RANGE))
        r = torch.stack([z[:, 0] - rho, _wrap(z[:, 1] - _wrap(torch.atan2(dy, dx) - xa[:, 2]))],
                        -1)
        # dh/d(landmark): range (d / |d|, 0 where clamped), bearing (-dy, dx) / |d|^2
        gx = torch.where(far, dx / dist, torch.zeros_like(dist))
        gy = torch.where(far, dy / dist, torch.zeros_like(dist))
        bx, by = -dy / q, dx / q
        o, l = torch.zeros_like(dx), torch.ones_like(dx)
        Jb = -torch.stack([gx, gy, bx, by], -1).reshape(-1, 2, 2)
        Ja = -torch.stack([-gx, -gy, o, -bx, -by, -l], -1).reshape(-1, 2, 3)
        out["obs"] = (e, r, Ja, Jb)
        return out

    def chi2(self, x, m: int) -> float:
        total = 0.0
        for kind, (e, r, _Ja, _Jb) in self.residuals(x, m).items():
            if kind == "odo":
                total += float(self.P.mm("ei,ei->", r, self.P.mm("eij,ej->ei", self.info[e], r)))
            else:
                total += float(self.P.mm("ei,ei->", r, r))     # identity information
        return total

    def step(self, m: int, n: int) -> torch.Tensor:
        """The Gauss-Newton step [N] over the first m edges and n vertices
        at the current states, N their rows (NaN where the factor fails)."""
        mm, dt = self.P.mm, self.P.dtype
        N = int(self.off[n])
        H = torch.zeros((N, N), dtype=dt, device=self.device)
        eta = torch.zeros(N, dtype=dt, device=self.device)
        for kind, (e, r, Ja, Jb) in self.residuals(self.x, m).items():
            if kind == "odo":
                W = self.info[e]
            else:
                W = torch.eye(2, dtype=dt, device=self.device).expand(len(e), 2, 2)
            WJ = (mm("eij,ejk->eik", W, Ja), mm("eij,ejk->eik", W, Jb))
            Wr = mm("eij,ej->ei", W, r)
            ends = (self.a_dev[e], self.b_dev[e])
            for u, Ju in enumerate((Ja, Jb)):
                ru = self.off_dev[ends[u]][:, None, None] + torch.arange(Ju.shape[2],
                                                                        device=self.device)[:, None]
                for v, WJv in enumerate(WJ):
                    cv = self.off_dev[ends[v]][:, None, None] + torch.arange(
                        WJv.shape[2], device=self.device)[None, :]
                    blk = mm("eji,ejk->eik", Ju, WJv)
                    H.view(-1).index_add_(0, (ru * N + cv).reshape(-1), blk.reshape(-1))
                idx = ru[:, :, 0]
                eta.index_add_(0, idx.reshape(-1), -mm("eji,ej->ei", Ju, Wr).reshape(-1))
        d = torch.arange(int(self.off[self.anchor]), int(self.off[self.anchor + 1]),
                         device=self.device)
        H[d, d] += 1.0
        L, info = torch.linalg.cholesky_ex(H)
        if int(info) != 0:
            return torch.full((N,), float("nan"), dtype=dt, device=self.device)
        return torch.cholesky_solve(eta[:, None], L).reshape(N)

    def push(self, dx, n: int):
        """x[:n] + dx: a pose's heading wrapped, a landmark's rows added."""
        lm = torch.as_tensor(self.is_lm[:n], device=self.device)
        rows = self.off_dev[:n, None] + torch.arange(3, device=self.device)
        pad = torch.cat([dx, dx.new_zeros(1)])          # a landmark's third row: 0
        rows = torch.where(lm[:, None] & (torch.arange(3, device=self.device) == 2),
                           torch.full_like(rows, len(dx)), rows)
        xn = self.x[:n] + pad[rows]
        self.x[:n] = torch.cat([xn[:, :2], torch.where(lm[:, None], xn[:, 2:], _wrap(xn[:, 2:]))],
                               -1)


def solve(scene, traffic: dict, P: Precision, device) -> dict:
    """The reference answer for the scene (as read) under traffic's
    ``every_n``, ``max_iterations`` and ``dx_threshold``: poses [N, 3] and
    landmarks [L, 2], each in vertex-id order, chi2, and the counts of
    solve points and pushes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    every_n = int(traffic["every_n"])
    max_it, thr = int(traffic["max_iterations"]), float(traffic["dx_threshold"])
    g = _Graph(scene, P, device)
    seen = np.zeros(len(g.ids), dtype=bool)
    n_active = last_nap = 0
    started = outstanding = False
    lin_dirty = True
    solves = pushes = pending = 0
    for k in range(len(g.a)):
        pending += 1
        for slot, v in enumerate((int(g.a[k]), int(g.b[k]))):
            if not seen[v]:
                seen[v] = True
                n_active += 1
                g.place(k, slot)
        outstanding = outstanding or (min(g.a[k], g.b[k]) + 2 < n_active)
        if n_active - last_nap < every_n:
            continue
        last_nap = n_active
        if not started:
            started = True
            pending = 0
        if not outstanding:
            continue
        outstanding = False
        pending = 0
        for _ in range(max_it):
            dx = g.step(k + 1, n_active)
            norm = float(torch.linalg.vector_norm(dx))
            if not math.isfinite(norm) or norm > STEP_REFUSED or norm <= thr:
                lin_dirty = True
                break
            g.push(dx, n_active)
            pushes += 1
            lin_dirty = False
        solves += 1
    m = len(g.a)
    # edges after the last solve point leave the linearization dirty
    if started and (lin_dirty or pending):
        dx = g.step(m, n_active)
        if bool(torch.isfinite(dx).all()):
            g.push(dx, n_active)
    x = g.x.detach().to("cpu", torch.float64).numpy()
    out = np.zeros((int(g.ids.max()) + 1, 3))
    out[g.ids] = x
    lm = np.zeros(int(g.ids.max()) + 1, dtype=bool)
    lm[g.ids] = g.is_lm
    pose_ids, lm_ids = np.sort(g.ids[~g.is_lm]), np.sort(g.ids[g.is_lm])

    def chi2_of(poses, landmarks) -> float:
        """chi2 of every edge at other states ([N, 3] poses, [L, 2]
        landmarks, each in vertex-id order), in this reference's precision."""
        full = np.zeros_like(out)
        full[pose_ids] = poses
        full[lm_ids, :2] = landmarks
        return g.chi2(torch.as_tensor(full[g.ids], device=g.device, dtype=P.dtype), m)

    return dict(poses=out[pose_ids], landmarks=out[lm_ids, :2], chi2=g.chi2(g.x, m),
                chi2_of=chi2_of, solve_points=solves, pushes=pushes)


def as_answer(ref: dict) -> dict:
    """A reference answer in the program's form (for a control in the
    program's place)."""
    return {"pose2d": ref["poses"], "landmark2d": ref["landmarks"], "chi2": ref["chi2"]}


def compare(program: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``, between the program's answer
    ("pose2d" [N, 3] and "landmark2d" [L, 2] by vertex id, "chi2") and the
    reference's: the relative gap of the program's chi2 from the chi2 that
    the reference computes at the program's own states; the widest gap of a
    pose's position and of its heading (radians); and the widest gap of a
    landmark's position.

    The chi2 is checked at the program's states, not against the
    reference's final chi2: on a stream whose replay is chaotic in float64
    (a few ulps in one measurement can move a push by one solve point), two
    correct float64 replays end at chi2s some percent apart, while the
    positions stay far closer to each other than the float32 control's."""
    d = program["pose2d"] - ref["poses"]
    at = ref["chi2_of"](program["pose2d"], program["landmark2d"])
    return {
        "chi2_of_states_rel": abs(program["chi2"] - at) / abs(at),
        "pose_t_gap": float(np.linalg.norm(d[:, :2], axis=1).max()),
        "pose_r_gap": float(np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))).max()),
        "landmark_gap": float(np.linalg.norm(program["landmark2d"] - ref["landmarks"],
                                             axis=1).max()),
    }
