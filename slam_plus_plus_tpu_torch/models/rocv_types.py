"""Range-only constant-velocity (ROCV) types (port of
slam_plus_plus_tpu/models/rocv_types.py, reference include/slam/ROCV_Types.h).

  * pos_vel3d vertex: [x y z vx vy vz], Euclidean ⊞ (ROCV_Types.h:31);
  * range edge (1D): r = z_range - |p - l| against a landmark3d transmitter
    (ROCV_Types.h:163-200);
  * const-velocity edge: the measurement is the time delta dt; the residual
    is the 6D deviation from the constant-velocity prediction [p + dt v, v]
    (ROCV_Types.h:454+), and its initializer places a missing vertex there;
  * landmark prior: the expectation/error pair with J = I and error 0, so
    chi2 is 0 and the edge is a pure curvature anchor whose parsed factor
    is the information (ROCV_Types.h:228,280-312).

Residuals are batched over a leading axis; the initializer is host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_plus_plus_tpu_torch.models.types import edge_type, vertex_type


def _additive(x, dx):
    return x + dx


POS_VEL3D = vertex_type("pos_vel3d", 6, 6, _additive, schur_class="pose")


def _range_residual(states, z):
    pv, lm = states
    dist = torch.sqrt(((pv[..., :3] - lm) ** 2).sum(-1) + 1e-30)
    return z - dist[..., None]


def _const_velocity_residual(states, z):
    """6D residual (the reference default, b_1D_residual = false): the
    deviation from the Newtonian constant-velocity prediction."""
    prev, cur = states
    dt = z[..., :1]
    pred = torch.cat([prev[..., :3] + dt * prev[..., 3:], prev[..., 3:]], dim=-1)
    return pred - cur


def _const_velocity_init(states, z):
    prev, cur = states
    if prev is None:
        prev = np.zeros(6)
    if cur is None:
        dt = float(z[0])
        cur = np.concatenate([prev[:3] + dt * prev[3:], prev[3:]])
    return prev, cur


def _lm_prior_residual(states, z):
    (lm,) = states
    return z - lm


def _lm_anchor_expectation(states):
    (lm,) = states
    return lm


def _lm_anchor_error(z, h):
    # reference CEdgeLandmark3DPrior: J = I, error = 0, chi2 = 0
    return torch.zeros_like(h)


def _lm_prior_init(states, z):
    return (np.asarray(z, float),) if states[0] is None else states


EDGE_ROCV_RANGE = edge_type("edge_rocv_range", ("pos_vel3d", "landmark3d"), 1, 1,
                            _range_residual)
EDGE_ROCV_CONST_VEL = edge_type("edge_rocv_const_vel", ("pos_vel3d", "pos_vel3d"), 6, 1,
                                _const_velocity_residual, _const_velocity_init)
EDGE_LANDMARK3D_PRIOR = edge_type("edge_landmark3d_prior", ("landmark3d",), 3, 3,
                                  _lm_prior_residual, _lm_prior_init,
                                  expectation=_lm_anchor_expectation, error=_lm_anchor_error)
