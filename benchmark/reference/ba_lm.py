"""Plain reference of batch bundle adjustment: Lambda-LM over
pinhole cameras and 3D points, with the Schur complement formed densely.

Semantics (SLAM++'s CNonlinearSolver_Lambda_LM, NonlinearSolver_Lambda_LM.h):

    alpha = 1e-3 * max per-observation camera-Hessian diagonal; nu = 2; fail = 10
    for iteration < max_iterations (grows by one per failed trial while fail > 0):
        dx <- solve(lambda + alpha I, eta)       (the gauge anchor I on the
                                                  first observation's camera)
        if |dx| <= threshold: break               (before the step is taken)
        rho = (chi2(x) - chi2(x ⊞ dx)) / (dx . (alpha dx + eta))
        rho > 0: take the step; alpha *= max(1/3, 1 - (2 rho - 1)^3); nu = 2
        else:    alpha *= nu; nu *= 2

Cameras are world->camera poses [t, q]; the update is right-composition,
t' = t + R dt and R' = R Exp(dtheta); the residual is z - project(R p + t).
The reduced camera system is formed densely ([6C, 6C]) from the pair
products of each point's observations, in blocks of points, and solved by a
dense Cholesky; a factor that fails leaves a non-finite step, which ends the
loop.  Every matrix product goes through ``Precision.mm``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import Precision

#: observations per block of the pair products
PAIR_BLOCK = 1 << 18


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _quat_of_rotvec(v):
    th = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = 0.5 * th
    s = torch.where(th > 1e-12, torch.sin(half) / torch.where(th > 1e-12, th, 1.0), 0.5)
    return torch.cat([torch.cos(half), v * s], -1)


def _rotmat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       -1).reshape(q.shape[:-1] + (3, 3))


def _skew(p):
    z = torch.zeros_like(p[:, 0])
    return torch.stack([z, -p[:, 2], p[:, 1], p[:, 2], z, -p[:, 0],
                        -p[:, 1], p[:, 0], z], -1).reshape(-1, 3, 3)


class _Problem:
    """The scene on one device in one precision."""

    def __init__(self, scene, P: Precision, device):
        self.P, dt = P, P.dtype
        qwc = torch.as_tensor(scene.cam_quat, dtype=torch.float64)         # x y z w
        qwc = qwc / torch.linalg.vector_norm(qwc, dim=-1, keepdim=True)
        q = torch.stack([qwc[:, 3], -qwc[:, 0], -qwc[:, 1], -qwc[:, 2]], -1)  # R_cw
        pos = torch.as_tensor(scene.cam_pos, dtype=torch.float64)
        t = -torch.einsum("cij,cj->ci", _rotmat(q), pos)
        intr = np.asarray(scene.intrinsics)
        if np.any(intr[:, 4] != 0):
            raise ValueError("the reference projects without distortion")
        self.t, self.q = t.to(device, dt), q.to(device, dt)
        self.p = torch.as_tensor(scene.points_init, device=device, dtype=dt)
        self.fx, self.fy, self.cx, self.cy = (torch.as_tensor(intr[:, k], device=device,
                                                              dtype=dt) for k in range(4))
        self.pid = torch.as_tensor(scene.obs_point, device=device)
        self.cid = torch.as_tensor(scene.obs_cam, device=device)
        self.z = torch.as_tensor(scene.obs_uv, device=device, dtype=dt)
        self.C, self.Pn = len(scene.cam_pos), len(scene.points_init)
        self.anchor = int(scene.obs_cam[0])
        # the observations of each point, grouped by degree
        order = np.argsort(scene.obs_point, kind="stable")
        deg = np.bincount(scene.obs_point, minlength=self.Pn)
        start = np.concatenate([[0], np.cumsum(deg)])
        self.groups = []
        for d in np.unique(deg[deg > 0]):
            pts = np.flatnonzero(deg == d)
            self.groups.append(torch.as_tensor(order[start[pts][:, None] + np.arange(d)],
                                               device=device))

    def residuals(self, t, q, p):
        """(e [E, 2], pc [E, 3], R_e [E, 3, 3], p_e [E, 3])."""
        R = _rotmat(q)[self.cid]
        pe = p[self.pid]
        pc = self.P.mm("eij,ej->ei", R, pe) + t[self.cid]
        iz = 1.0 / pc[:, 2]
        h = torch.stack([self.fx[self.cid] * pc[:, 0] * iz + self.cx[self.cid],
                         self.fy[self.cid] * pc[:, 1] * iz + self.cy[self.cid]], -1)
        return self.z - h, pc, R, pe

    def chi2(self, t, q, p):
        e = self.residuals(t, q, p)[0]
        return torch.sum(e * e)

    def linearize(self):
        """The undamped system at the current states: camera blocks [C, 6, 6],
        point blocks [P, 3, 3], per-observation camera-point blocks
        [E, 6, 3], eta_c [C, 6], eta_p [P, 3], chi2, max diagonal."""
        mm = self.P.mm
        e, pc, R, pe = self.residuals(self.t, self.q, self.p)
        iz = 1.0 / pc[:, 2]
        fx, fy = self.fx[self.cid], self.fy[self.cid]
        zero = torch.zeros_like(iz)
        Dh = torch.stack([fx * iz, zero, -fx * pc[:, 0] * iz * iz,
                          zero, fy * iz, -fy * pc[:, 1] * iz * iz], -1).reshape(-1, 2, 3)
        DR = mm("eij,ejk->eik", Dh, R)
        Jp = -DR                                                  # d e / d p
        Jc = torch.cat([Jp, mm("eij,ejk->eik", DR, _skew(pe))], -1)  # d e / d (dt, dtheta)
        hcc = mm("eki,ekj->eij", Jc, Jc)
        hcp = mm("eki,ekj->eij", Jc, Jp)
        hpp = mm("eki,ekj->eij", Jp, Jp)
        gc = -mm("eki,ek->ei", Jc, e)
        gp = -mm("eki,ek->ei", Jp, e)
        dt = self.P.dtype
        Hc = torch.zeros((self.C, 6, 6), dtype=dt, device=e.device).index_add_(0, self.cid, hcc)
        Hp = torch.zeros((self.Pn, 3, 3), dtype=dt, device=e.device).index_add_(0, self.pid, hpp)
        ec = torch.zeros((self.C, 6), dtype=dt, device=e.device).index_add_(0, self.cid, gc)
        ep = torch.zeros((self.Pn, 3), dtype=dt, device=e.device).index_add_(0, self.pid, gp)
        Hc[self.anchor] += torch.eye(6, dtype=dt, device=e.device)
        max_diag = torch.diagonal(hcc, dim1=1, dim2=2).amax()
        return dict(Hc=Hc, Hp=Hp, hcp=hcp, ec=ec, ep=ep, chi2=torch.sum(e * e),
                    max_diag=max_diag)

    def solve(self, lin, alpha: float):
        """(dx_c [C, 6], dx_p [P, 3]) of the damped system, by the dense
        Schur complement on the cameras."""
        mm, dt = self.P.mm, self.P.dtype
        dev = lin["Hc"].device
        I3, I6 = torch.eye(3, dtype=dt, device=dev), torch.eye(6, dtype=dt, device=dev)
        Cinv = torch.linalg.inv(lin["Hp"] + alpha * I3)
        hcp = lin["hcp"]
        W = mm("eij,ejk->eik", hcp, Cinv[self.pid])                       # [E, 6, 3]
        rhs = lin["ec"] - torch.zeros_like(lin["ec"]).index_add_(
            0, self.cid, mm("eij,ej->ei", W, lin["ep"][self.pid]))
        n = 6 * self.C
        S = torch.zeros((n, n), dtype=dt, device=dev)
        blocks = lin["Hc"] + alpha * I6
        idx = 6 * torch.arange(self.C, device=dev)[:, None] + torch.arange(6, device=dev)
        S[idx[:, :, None], idx[:, None, :]] = blocks
        ar6 = torch.arange(6, device=dev)
        for g in self.groups:
            d = g.shape[1]
            step = max(1, PAIR_BLOCK // (d * d))
            for lo in range(0, len(g), step):
                ob = g[lo:lo + step]                                           # [b, d]
                prod = mm("bmil,bnjl->bmnij", W[ob], hcp[ob])                  # W_a U_b^T
                ca = self.cid[ob]
                rows = (6 * ca[:, :, None, None, None] + ar6[:, None])         # [b, d, 1, 6, 1]
                cols = (6 * ca[:, None, :, None, None] + ar6[None, :])         # [b, 1, d, 1, 6]
                flat = torch.broadcast_tensors(rows * n + cols, prod)[0]
                S.view(-1).index_add_(0, flat.reshape(-1), prod.reshape(-1), alpha=-1)
        L, info = torch.linalg.cholesky_ex(S)
        if int(info) != 0:
            nan = torch.full((self.C, 6), float("nan"), dtype=dt, device=dev)
            return nan, torch.full((self.Pn, 3), float("nan"), dtype=dt, device=dev)
        dxc = torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(self.C, 6)
        back = torch.zeros_like(lin["ep"]).index_add_(
            0, self.pid, mm("eji,ej->ei", hcp, dxc[self.cid]))
        dxp = mm("pij,pj->pi", Cinv, lin["ep"] - back)
        return dxc, dxp

    def update(self, dxc, dxp):
        R = _rotmat(self.q)
        t = self.t + self.P.mm("cij,cj->ci", R, dxc[:, :3])
        q = _quat_mul(self.q, _quat_of_rotvec(dxc[:, 3:]))
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return t, q, self.p + dxp


def solve(scene, traffic: dict, P: Precision, device) -> dict:
    """The reference answer for the scene (as read): the states after
    traffic's Levenberg-Marquardt iterations (``iterations``,
    ``dx_threshold``), in float64 numpy: cams_t [C, 3], cams_q [C, 4] (w x y
    z, world->camera), points [P, 3], chi2, iterations."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if traffic["solver"] != "lm":
        raise ValueError(f"ba_lm reference: no solver {traffic['solver']!r}")
    pr = _Problem(scene, P, device)
    max_it, thr = int(traffic["iterations"]), float(traffic["dx_threshold"])
    lin = pr.linearize()
    alpha = 1e-3 * float(lin["max_diag"])
    nu, fail = 2.0, 10
    last = float(lin["chi2"])
    it = n_it = 0
    while it < max_it:
        it += 1
        n_it += 1
        dxc, dxp = pr.solve(lin, alpha)
        norm = math.sqrt(float(torch.sum(dxc * dxc) + torch.sum(dxp * dxp)))
        if not math.isfinite(norm) or norm <= thr:
            break
        t, q, p = pr.update(dxc, dxp)
        err = float(pr.chi2(t, q, p))
        denom = float(torch.sum(dxc * (alpha * dxc + lin["ec"])) +
                      torch.sum(dxp * (alpha * dxp + lin["ep"])))
        rho = (last - err) / denom if denom != 0.0 else -1.0
        if rho > 0:
            alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            last = err
            pr.t, pr.q, pr.p = t, q, p
            lin = pr.linearize()
        else:
            alpha *= nu
            nu *= 2.0
            if fail > 0:
                fail -= 1
                max_it += 1
    chi2 = float(pr.chi2(pr.t, pr.q, pr.p))

    def host(x):
        return x.detach().to("cpu", torch.float64).numpy()

    return dict(cams_t=host(pr.t), cams_q=host(pr.q), points=host(pr.p), chi2=chi2,
                iterations=n_it)


def as_answer(ref: dict) -> dict:
    """A reference answer in the program's form (for a control in the
    program's place)."""
    q = ref["cams_q"] * np.where(ref["cams_q"][:, :1] < 0, -1.0, 1.0)
    vn = np.linalg.norm(q[:, 1:], axis=1, keepdims=True)
    ang = 2.0 * np.arctan2(vn, q[:, :1])
    aa = q[:, 1:] * np.where(vn > 1e-12, ang / np.where(vn > 1e-12, vn, 1.0), 2.0)
    return {"cam": np.concatenate([ref["cams_t"], aa], 1), "xyz": ref["points"],
            "chi2": ref["chi2"]}


def _quat_of_aa(aa: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(aa, axis=1, keepdims=True)
    s = np.where(th > 1e-12, np.sin(0.5 * th) / np.where(th > 1e-12, th, 1.0), 0.5)
    return np.concatenate([np.cos(0.5 * th), aa * s], 1)


def compare(program: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: chi2's relative gap, and the
    widest gap of a camera's translation, of a camera's rotation (radians)
    and of a point, between the program's answer ("cam" [C, 11] as the port
    stores a camera: t, axis-angle, intrinsics; "xyz" [P, 3]; "chi2") and
    the reference's."""
    cams = program["cam"]
    qa = _quat_of_aa(cams[:, 3:6])
    qb = ref["cams_q"]
    # the angle of qa^-1 qb
    w = np.sum(qa * qb, axis=1)
    v = (qa[:, :1] * qb[:, 1:] - qb[:, :1] * qa[:, 1:] - np.cross(qa[:, 1:], qb[:, 1:]))
    rot = 2.0 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w))
    return {
        "chi2_rel": abs(program["chi2"] - ref["chi2"]) / abs(ref["chi2"]),
        "cam_t_gap": float(np.linalg.norm(cams[:, :3] - ref["cams_t"], axis=1).max()),
        "cam_r_gap": float(rot.max()),
        "point_gap": float(np.linalg.norm(program["xyz"] - ref["points"], axis=1).max()),
    }
