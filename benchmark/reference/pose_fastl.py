"""Plain reference of an incremental 2D pose-graph replay with FastL's
semantics (SLAM++'s CNonlinearSolver_FastL, NonlinearSolver_FastL.h, run as
the CLI's ``-nsp N -fL``).

Edges arrive in file order.  A vertex is new when an edge first names it:
the first edge's first vertex at the origin, any other at its edge's other
end composed with the measurement.  An edge closes a loop when its older
vertex lies more than its arity behind the newest.  Every time N new vertices
have arrived (a solve point) and a loop closure is outstanding, the solver
runs up to ``max_iterations`` Gauss-Newton steps on every edge so far at
the current linearization: a step longer than ``dx_threshold`` (and
finite, and under 1e5) is taken, and the system is linearized anew;
otherwise it is discarded and the linearization stays.  At the end the
solution is the linearization point plus one more step (the one-time dx).
The first solve point only starts the system.

Lambda is formed densely over the vertices that have arrived ([3n, 3n]),
with the gauge anchor I on the first edge's first vertex, and solved by a
dense Cholesky; a factor that fails gives a non-finite step, which is
discarded.  Every matrix product goes through ``Precision.mm``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import Precision

#: a step at least this long is refused outright (a near-singular system)
STEP_REFUSED = 1e5


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


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
        self.z = torch.as_tensor(scene.z, device=device, dtype=dt)
        self.info = torch.as_tensor(scene.info, device=device, dtype=dt)
        self.a_dev = torch.as_tensor(self.a, device=device)
        self.b_dev = torch.as_tensor(self.b, device=device)
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
        c, s = torch.cos(xa[2]), torch.sin(xa[2])
        self.x[b] = torch.stack([xa[0] + c * z[0] - s * z[1], xa[1] + s * z[0] + c * z[1],
                                 _wrap(xa[2] + z[2])])

    def residuals(self, x, m: int):
        """(r [m, 3], Ja [m, 3, 3], Jb [m, 3, 3]) of the first m edges."""
        a, b = self.a_dev[:m], self.b_dev[:m]
        xa, xb = x[a], x[b]
        c, s = torch.cos(xa[:, 2]), torch.sin(xa[:, 2])
        dx, dy = xb[:, 0] - xa[:, 0], xb[:, 1] - xa[:, 1]
        h = torch.stack([c * dx + s * dy, -s * dx + c * dy, _wrap(xb[:, 2] - xa[:, 2])], -1)
        r = self.z[:m] - h
        r = torch.cat([r[:, :2], _wrap(r[:, 2:])], -1)
        o, l = torch.zeros_like(c), torch.ones_like(c)
        # J = -dh/dx
        Ja = -torch.stack([-c, -s, -s * dx + c * dy, s, -c, -c * dx - s * dy, o, o, -l],
                          -1).reshape(-1, 3, 3)
        Jb = -torch.stack([c, s, o, -s, c, o, o, o, l], -1).reshape(-1, 3, 3)
        return r, Ja, Jb

    def chi2(self, x, m: int) -> float:
        r = self.residuals(x, m)[0]
        return float(self.P.mm("ei,ei->", r, self.P.mm("eij,ej->ei", self.info[:m], r)))

    def step(self, m: int, n: int) -> torch.Tensor:
        """The Gauss-Newton step [n, 3] over the first m edges and n
        vertices at the current states (NaN where the factor fails)."""
        mm, dt = self.P.mm, self.P.dtype
        r, Ja, Jb = self.residuals(self.x, m)
        W = self.info[:m]
        WJa, WJb = mm("eij,ejk->eik", W, Ja), mm("eij,ejk->eik", W, Jb)
        blocks = {(0, 0): mm("eji,ejk->eik", Ja, WJa), (0, 1): mm("eji,ejk->eik", Ja, WJb),
                  (1, 0): mm("eji,ejk->eik", Jb, WJa), (1, 1): mm("eji,ejk->eik", Jb, WJb)}
        Wr = mm("eij,ej->ei", W, r)
        ends = (self.a_dev[:m], self.b_dev[:m])
        N = 3 * n
        H = torch.zeros((N, N), dtype=dt, device=self.device)
        ar = torch.arange(3, device=self.device)
        for (u, v), blk in blocks.items():
            rows = (3 * ends[u])[:, None, None] + ar[:, None]
            cols = (3 * ends[v])[:, None, None] + ar[None, :]
            H.view(-1).index_add_(0, (rows * N + cols).reshape(-1), blk.reshape(-1))
        eta = torch.zeros(N, dtype=dt, device=self.device)
        for u, J in enumerate((Ja, Jb)):
            idx = (3 * ends[u])[:, None] + ar
            eta.index_add_(0, idx.reshape(-1), -mm("eji,ej->ei", J, Wr).reshape(-1))
        d = torch.arange(3 * self.anchor, 3 * self.anchor + 3, device=self.device)
        H[d, d] += 1.0
        L, info = torch.linalg.cholesky_ex(H)
        if int(info) != 0:
            return torch.full((n, 3), float("nan"), dtype=dt, device=self.device)
        return torch.cholesky_solve(eta[:, None], L).reshape(n, 3)

    def push(self, dx, n: int):
        xn = self.x[:n] + dx
        self.x[:n] = torch.cat([xn[:, :2], _wrap(xn[:, 2:])], -1)


def solve(scene, traffic: dict, P: Precision, device) -> dict:
    """The reference answer for the scene (as read) under traffic's
    ``every_n``, ``max_iterations`` and ``dx_threshold``: poses [N, 3] in
    vertex-id order, chi2, and the counts of solve points and pushes."""
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
    poses = np.zeros((int(g.ids.max()) + 1, 3))
    poses[g.ids] = x
    return dict(poses=poses, chi2=g.chi2(g.x, m), solve_points=solves, pushes=pushes)


def as_answer(ref: dict) -> dict:
    """A reference answer in the program's form (for a control in the
    program's place)."""
    return {"pose2d": ref["poses"], "chi2": ref["chi2"]}


def compare(program: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: chi2's relative gap, and the
    widest gap of a pose's position and of its heading (radians), between
    the program's answer ("pose2d" [N, 3] by vertex id, "chi2") and the
    reference's."""
    d = program["pose2d"] - ref["poses"]
    return {
        "chi2_rel": abs(program["chi2"] - ref["chi2"]) / abs(ref["chi2"]),
        "pose_t_gap": float(np.linalg.norm(d[:, :2], axis=1).max()),
        "pose_r_gap": float(np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))).max()),
    }
