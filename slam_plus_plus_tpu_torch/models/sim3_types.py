"""Sim(3) incremental-SfM types (port of slam_plus_plus_tpu/models/sim3_types.py,
reference include/slam/Sim3_Types.h).

Vertices:
  * cam_sim3 stores 12: [t(3) aa(3) s(1)] (world->camera Sim3, tRs) +
    intrinsics [fx fy cx cy d'] (Sim3_Types.h:178 CVertexCamSim3); tangent 7,
    ⊞ composes with Exp of the sim(3) delta on the first 7;
  * sim3_pose: a bare Sim3 (7 / 7);
  * landmarks: inv_depth [u, v, q] (3 / 3), inv_dist (1 / 1) and inv_dist4
    [dx, dy, dz, q], a direction in the owner camera's frame that stays
    constant and the optimized inverse distance q (4 / 1, reference
    CVertexInvDist, Sim3_Types.h:102).

Edges: the reference's grid (Sim3_Types.h:247-3598), {XYZ, InvDepth, InvDist}
landmarks x {G: world frame, LS: owner-local self-observation, LO:
owner-local other-observation} x {P2C: intrinsics of the camera vertex,
P2CI: a separate intrinsics vertex} x {pixel, angle} error, the Landmark
family of direct 3D observations, and the Sim3 pose-pose edge — 31 types in
all, as the JAX package registers them.  The unary LS edges carry the
owner's intrinsics in the measurement tail [u, v, fx, fy, cx, cy, d]; the
LO edges are three-slot (owner camera, observer camera, landmark), or four
with the intrinsics vertex.  Residuals are batched over a leading axis and
run through the generic per-edge assembly path.
"""

from __future__ import annotations

import torch

from slam_plus_plus_tpu_torch.manifolds import sim3
from slam_plus_plus_tpu_torch.models.types import edge_type, vertex_type


def _cam_sim3_boxplus(x, dx):
    return torch.cat([sim3.boxplus(x[..., :7], dx), x[..., 7:]], dim=-1)


def _additive(x, dx):
    return x + dx


def _inv_dist4_boxplus(x, dx):
    return torch.cat([x[..., :3], x[..., 3:] + dx], dim=-1)


CAM_SIM3 = vertex_type("cam_sim3", 12, 7, _cam_sim3_boxplus, schur_class="pose")
SIM3_POSE = vertex_type("sim3_pose", 7, 7, sim3.boxplus, schur_class="pose")
INV_DEPTH = vertex_type("inv_depth", 3, 3, _additive, schur_class="landmark")
INV_DIST = vertex_type("inv_dist", 1, 1, _additive, schur_class="landmark")
INV_DIST4 = vertex_type("inv_dist4", 4, 1, _inv_dist4_boxplus, schur_class="landmark")


# ---- shared math -----------------------------------------------------------

def _project_local(x, fx, fy, cx, cy, d):
    """Pinhole + pixel-space radial distortion of camera-frame points
    [..., 3]; the intrinsics are [...] tensors."""
    k = d / (0.5 * (fx + fy))
    inv_z = 1.0 / x[..., 2]
    u = fx * x[..., 0] * inv_z + cx
    v = fy * x[..., 1] * inv_z + cy
    du, dv = u - cx, v - cy
    w = 1.0 + k * (du * du + dv * dv)
    return torch.stack([cx + w * du, cy + w * dv], dim=-1)


def _intr_of(cam_state):
    return cam_state[..., 7:12].unbind(-1)


def _intr_vertex(intr):
    return intr[..., :5].unbind(-1)


def _project_sim3(cam_state, point_world):
    """Transform by the world->camera Sim3, then pinhole + radial distortion
    (same pixel-space distortion as the BA path)."""
    return _project_local(sim3.transform_point(cam_state[..., :7], point_world),
                          *_intr_of(cam_state))


def _safe_q(q):
    sign = torch.where(q == 0, torch.ones_like(q), torch.sign(q))
    return sign * torch.clamp_min(torch.abs(q), 1e-12)


def _invdepth_to_xyz(lm):
    """inv_depth [u, v, q] -> [u/q, v/q, 1/q]."""
    return torch.cat([lm[..., :2], torch.ones_like(lm[..., 2:])], dim=-1) / \
        _safe_q(lm[..., 2:3])


def _invdist4_to_xyz(lm):
    """inv_dist4 [dir, q] -> dir / q."""
    return lm[..., :3] / _safe_q(lm[..., 3:4])


def _world_to_cam(cam_state, pw):
    return sim3.transform_point(cam_state[..., :7], pw)


def _local_to_cam(owner, observer, p_local):
    """Owner-local points seen from the observer: world = owner^-1 o local
    (the storage is world->camera)."""
    pw = sim3.transform_point(sim3.inverse(owner[..., :7]), p_local)
    return sim3.transform_point(observer[..., :7], pw)


def _to_world(owner, p_local):
    return sim3.transform_point(sim3.inverse(owner[..., :7]), p_local)


def _z_intr(z7):
    """LS unary edges carry the owner's constant intrinsics in the
    measurement tail [u, v, fx, fy, cx, cy, d] (Sim3_Types.h:732)."""
    return z7[..., :2], z7[..., 2:7].unbind(-1)


def _angle_err3(x_cam, z, fx, fy, cx, cy, d):
    """Reference *_AngleErr residual (Sim3SolverBase.h:2920-2965): the cross
    product of the normalized predicted ray and the normalized undistorted
    observation ray, a 3-vector whose norm is sin(angle).  Keeps the
    reference's k = d / (.5 * fx * fy) and the fixed-point undistortion."""
    k = d / (0.5 * fx * fy)
    duv = z - torch.stack([cx, cy], dim=-1)
    dud = duv
    for _ in range(5):
        r2 = (dud * dud).sum(-1, keepdim=True)
        dud = duv / (1.0 + k[..., None] * r2)
    x_inv = torch.stack([dud[..., 0] / fx, dud[..., 1] / fy, torch.ones_like(fx)], dim=-1)
    a = x_cam / torch.linalg.vector_norm(x_cam, dim=-1, keepdim=True)
    b = x_inv / torch.linalg.vector_norm(x_inv, dim=-1, keepdim=True)
    return torch.linalg.cross(a, b, dim=-1)


# ---- the first-round subset (world-frame XYZ, pose-pose, inverse depth/dist) --

def _p2c_sim3_residual(states, z):
    cam_state, point = states
    return z - _project_sim3(cam_state, point)


def _pose_cam_sim3_residual(states, z):
    """Sim3 pose-pose edge (CEdgePoseCamSim3): r = log(z^-1 * (x0^-1 x1))."""
    x0, x1 = states
    rel = sim3.relative_to(x0[..., :7], x1[..., :7])
    return sim3.log(sim3.compose(sim3.inverse(z[..., :7]), rel))


def _p2c_invdepth_lo_residual(states, z):
    """Other-observing inverse-depth edge: landmark owned by cam0, observed
    by cam1 (LO family)."""
    owner, observer, lm = states
    return z - _project_sim3(observer, _to_world(owner, _invdepth_to_xyz(lm)))


def _p2c_invdepth_ls_residual(states, z):
    """Self-observing inverse-depth edge: projecting into the owner itself."""
    owner, lm = states
    return z - _project_sim3(owner, _to_world(owner, _invdepth_to_xyz(lm)))


def _p2c_xyz_ls_residual(states, z):
    """Self-observing XYZ edge: a world point into the owner camera."""
    owner, lm = states
    return z - _project_sim3(owner, lm)


def _p2c_invdist_lo_residual(states, z):
    owner, observer, lm = states
    return z - _project_sim3(observer, _to_world(owner, _invdist4_to_xyz(lm)))


def _p2c_invdist_ls_residual(states, z):
    owner, lm = states
    return z - _project_sim3(owner, _to_world(owner, _invdist4_to_xyz(lm)))


def _p2ci_xyz_sim3_residual(states, z):
    cam, lm, intr = states
    return z - _project_local(_world_to_cam(cam, lm), *_intr_vertex(intr))


# ---- G family: world-frame landmarks ----------------------------------------

def _p2c_invdepth_g(states, z):
    lm, cam = states
    return z - _project_local(_world_to_cam(cam, _invdepth_to_xyz(lm)), *_intr_of(cam))


def _p2c_invdist_g(states, z):
    lm, cam = states
    return z - _project_local(_world_to_cam(cam, _invdist4_to_xyz(lm)), *_intr_of(cam))


def _p2ci_invdepth_g(states, z):
    lm, cam, intr = states
    return z - _project_local(_world_to_cam(cam, _invdepth_to_xyz(lm)), *_intr_vertex(intr))


# ---- LS family: owner-local landmarks, self-observation -------------------
# As in the reference, the P2C ones are unary in the landmark (the owner pose
# cancels out of its own observation, Sim3_Types.h:726).

def _p2c_xyz_ls_unary(states, z7):
    (lm,) = states
    z, intr = _z_intr(z7)
    return z - _project_local(lm, *intr)


def _p2c_invdepth_ls_unary(states, z7):
    (lm,) = states
    z, intr = _z_intr(z7)
    return z - _project_local(_invdepth_to_xyz(lm), *intr)


def _p2c_invdist_ls_unary(states, z7):
    (lm,) = states
    z, intr = _z_intr(z7)
    return z - _project_local(_invdist4_to_xyz(lm), *intr)


def _p2ci_xyz_ls(states, z):
    lm, intr = states
    return z - _project_local(lm, *_intr_vertex(intr))


def _p2ci_invdepth_ls(states, z):
    lm, intr = states
    return z - _project_local(_invdepth_to_xyz(lm), *_intr_vertex(intr))


# ---- LO family: owner-local landmarks, other-observation ------------------

def _p2c_xyz_lo(states, z):
    owner, observer, lm = states
    return z - _project_local(_local_to_cam(owner, observer, lm), *_intr_of(observer))


def _p2ci_xyz_lo(states, z):
    owner, observer, lm, intr = states
    return z - _project_local(_local_to_cam(owner, observer, lm), *_intr_vertex(intr))


def _p2ci_invdepth_lo(states, z):
    owner, observer, lm, intr = states
    return z - _project_local(_local_to_cam(owner, observer, _invdepth_to_xyz(lm)),
                              *_intr_vertex(intr))


# ---- Landmark family: direct 3D observation (Sim3_Types.h:2129-2610) ------

def _landmark_xyz_ls(states, z):
    (lm,) = states
    return z - lm


def _landmark_xyz_lo(states, z):
    owner, observer, lm = states
    return z - _local_to_cam(owner, observer, lm)


def _landmark_invdepth_ls(states, z):
    (lm,) = states
    return z - _invdepth_to_xyz(lm)


def _landmark_invdepth_lo(states, z):
    owner, observer, lm = states
    return z - _local_to_cam(owner, observer, _invdepth_to_xyz(lm))


# ---- AngleErr family (3D cross-product residual) --------------------------

def _p2c_xyz_angle(states, z):
    cam, lm = states
    return _angle_err3(_world_to_cam(cam, lm), z, *_intr_of(cam))


def _p2ci_xyz_angle(states, z):
    cam, lm, intr = states
    return _angle_err3(_world_to_cam(cam, lm), z, *_intr_vertex(intr))


def _p2c_invdepth_angle(states, z):
    cam, lm = states
    return _angle_err3(_world_to_cam(cam, _invdepth_to_xyz(lm)), z, *_intr_of(cam))


def _p2ci_invdepth_angle(states, z):
    cam, lm, intr = states
    return _angle_err3(_world_to_cam(cam, _invdepth_to_xyz(lm)), z, *_intr_vertex(intr))


def _p2ci_xyz_angle_ls(states, z):
    lm, intr = states
    return _angle_err3(lm, z, *_intr_vertex(intr))


def _p2ci_xyz_angle_lo(states, z):
    owner, observer, lm, intr = states
    return _angle_err3(_local_to_cam(owner, observer, lm), z, *_intr_vertex(intr))


def _p2ci_invdepth_angle_ls(states, z):
    lm, intr = states
    return _angle_err3(_invdepth_to_xyz(lm), z, *_intr_vertex(intr))


def _p2ci_invdepth_angle_lo(states, z):
    owner, observer, lm, intr = states
    return _angle_err3(_local_to_cam(owner, observer, _invdepth_to_xyz(lm)), z,
                       *_intr_vertex(intr))


_C, _I = "cam_sim3", "intrinsics"

#: name -> (vertex types, residual dim, measurement dim, residual)
_EDGES = {
    "edge_p2c_sim3": ((_C, "xyz"), 2, 2, _p2c_sim3_residual),
    "edge_pose_cam_sim3": ((_C, _C), 7, 7, _pose_cam_sim3_residual),
    "edge_p2c_invdepth_lo": ((_C, _C, "inv_depth"), 2, 2, _p2c_invdepth_lo_residual),
    "edge_p2c_invdepth_ls": ((_C, "inv_depth"), 2, 2, _p2c_invdepth_ls_residual),
    "edge_p2c_xyz_ls": ((_C, "xyz"), 2, 2, _p2c_xyz_ls_residual),
    "edge_p2c_invdist_lo": ((_C, _C, "inv_dist4"), 2, 2, _p2c_invdist_lo_residual),
    "edge_p2c_invdist_ls": ((_C, "inv_dist4"), 2, 2, _p2c_invdist_ls_residual),
    "edge_p2ci_xyz_sim3": ((_C, "xyz", _I), 2, 2, _p2ci_xyz_sim3_residual),
    "edge_p2c_invdepth_g": (("inv_depth", _C), 2, 2, _p2c_invdepth_g),
    "edge_p2c_invdist_g": (("inv_dist4", _C), 2, 2, _p2c_invdist_g),
    "edge_p2ci_invdepth_g": (("inv_depth", _C, _I), 2, 2, _p2ci_invdepth_g),
    "edge_p2c_xyz_ls_u": (("xyz",), 2, 7, _p2c_xyz_ls_unary),
    "edge_p2c_invdepth_ls_u": (("inv_depth",), 2, 7, _p2c_invdepth_ls_unary),
    "edge_p2c_invdist_ls_u": (("inv_dist4",), 2, 7, _p2c_invdist_ls_unary),
    "edge_p2ci_xyz_ls": (("xyz", _I), 2, 2, _p2ci_xyz_ls),
    "edge_p2ci_invdepth_ls": (("inv_depth", _I), 2, 2, _p2ci_invdepth_ls),
    "edge_p2c_xyz_lo": ((_C, _C, "xyz"), 2, 2, _p2c_xyz_lo),
    "edge_p2ci_xyz_lo": ((_C, _C, "xyz", _I), 2, 2, _p2ci_xyz_lo),
    "edge_p2ci_invdepth_lo": ((_C, _C, "inv_depth", _I), 2, 2, _p2ci_invdepth_lo),
    "edge_landmark_xyz_ls": (("xyz",), 3, 3, _landmark_xyz_ls),
    "edge_landmark_xyz_lo": ((_C, _C, "xyz"), 3, 3, _landmark_xyz_lo),
    "edge_landmark_invdepth_ls": (("inv_depth",), 3, 3, _landmark_invdepth_ls),
    "edge_landmark_invdepth_lo": ((_C, _C, "inv_depth"), 3, 3, _landmark_invdepth_lo),
    "edge_p2c_xyz_angle": ((_C, "xyz"), 3, 2, _p2c_xyz_angle),
    "edge_p2ci_xyz_angle": ((_C, "xyz", _I), 3, 2, _p2ci_xyz_angle),
    "edge_p2c_invdepth_angle": ((_C, "inv_depth"), 3, 2, _p2c_invdepth_angle),
    "edge_p2ci_invdepth_angle": ((_C, "inv_depth", _I), 3, 2, _p2ci_invdepth_angle),
    "edge_p2ci_xyz_angle_ls": (("xyz", _I), 3, 2, _p2ci_xyz_angle_ls),
    "edge_p2ci_xyz_angle_lo": ((_C, _C, "xyz", _I), 3, 2, _p2ci_xyz_angle_lo),
    "edge_p2ci_invdepth_angle_ls": (("inv_depth", _I), 3, 2, _p2ci_invdepth_angle_ls),
    "edge_p2ci_invdepth_angle_lo": ((_C, _C, "inv_depth", _I), 3, 2,
                                    _p2ci_invdepth_angle_lo),
}

for _name, (_vts, _rdim, _mdim, _fn) in _EDGES.items():
    edge_type(_name, _vts, _rdim, _mdim, _fn)
