"""Port parity: batched torch manifold math and robust weights against the
JAX functions (vmapped) on seeded random batches, float64, <= 1e-12
absolute."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.manifolds import camera as jcam
from slam_plus_plus_tpu.manifolds import se2 as jse2
from slam_plus_plus_tpu.manifolds import se3 as jse3
from slam_plus_plus_tpu.manifolds import so3 as jso3
from slam_plus_plus_tpu.models import ba_types as jba
from slam_plus_plus_tpu.robust import losses as jlosses
from slam_plus_plus_tpu_torch.manifolds import camera as tcam
from slam_plus_plus_tpu_torch.manifolds import se2 as tse2
from slam_plus_plus_tpu_torch.manifolds import se3 as tse3
from slam_plus_plus_tpu_torch.manifolds import so3 as tso3
from slam_plus_plus_tpu_torch.models import ba_types as tba
from slam_plus_plus_tpu_torch.robust import losses as tlosses

TOL = 1e-12
N = 257


def _aa(rng):
    """Axis-angles: generic, tiny (Taylor branch), zero, and beyond pi."""
    aa = rng.normal(0, 1.0, (N, 3))
    aa[:8] *= 1e-13
    aa[8] = 0.0
    aa[9:16] *= 4.0 / np.linalg.norm(aa[9:16], axis=1, keepdims=True)
    return aa


def _quat(rng):
    q = rng.normal(0, 1.0, (N, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:4, 1:] *= 1e-14          # near-identity, both signs of w
    q[4] = [-1.0, 0.0, 0.0, 0.0]
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pose(rng):
    return np.concatenate([rng.normal(0, 2.0, (N, 3)), _aa(rng)], axis=1)


def _pose2(rng):
    """SE(2) poses with headings over several turns (wrapping)."""
    return np.concatenate([rng.normal(0, 3.0, (N, 2)), rng.uniform(-9, 9, (N, 1))], axis=1)


def _xy(rng):
    return rng.normal(0, 3.0, (N, 2))


def _angle(rng):
    a = rng.uniform(-20, 20, N)
    a[:4] = [np.pi, -np.pi, 0.0, 3 * np.pi]
    return a


def _intrinsics(rng):
    f = rng.uniform(300, 700, (N, 2))
    c = rng.uniform(200, 400, (N, 2))
    d = rng.normal(0, 1e-7, (N, 1)) * f.mean(1, keepdims=True)  # k r^2 ~ 1e-2
    return np.concatenate([f, c, d], axis=1)


def _point(rng):
    p = rng.uniform(-2, 2, (N, 3))
    p[:, 2] += 6.0
    return p


CASES = {
    "axis_angle_to_quat": (jso3.axis_angle_to_quat, tso3.axis_angle_to_quat, (_aa,)),
    "quat_to_axis_angle": (jso3.quat_to_axis_angle, tso3.quat_to_axis_angle, (_quat,)),
    "quat_to_rotmat": (jso3.quat_to_rotmat, tso3.quat_to_rotmat, (_quat,)),
    "axis_angle_to_rotmat": (jso3.axis_angle_to_rotmat, tso3.axis_angle_to_rotmat, (_aa,)),
    "quat_multiply": (jso3.quat_multiply, tso3.quat_multiply, (_quat, _quat)),
    "quat_conjugate": (jso3.quat_conjugate, tso3.quat_conjugate, (_quat,)),
    "quat_rotate": (jso3.quat_rotate, tso3.quat_rotate, (_quat, _point)),
    "se3_compose": (jse3.compose, tse3.compose, (_pose, _pose)),
    "se3_boxplus": (jse3.boxplus, tse3.boxplus, (_pose, lambda r: 0.1 * _pose(r))),
    "se3_relative_to": (jse3.relative_to, tse3.relative_to, (_pose, _pose)),
    "se3_inverse": (jse3.inverse, tse3.inverse, (_pose,)),
    "se3_pose_error": (jse3.pose_error, tse3.pose_error, (_pose, _pose)),
    "se3_landmark_in_frame": (jse3.landmark_in_frame, tse3.landmark_in_frame,
                              (_pose, _point)),
    "se2_wrap_angle": (jse2.wrap_angle, tse2.wrap_angle, (_angle,)),
    "se2_compose": (jse2.compose, tse2.compose, (_pose2, _pose2)),
    "se2_relative_to": (jse2.relative_to, tse2.relative_to, (_pose2, _pose2)),
    "se2_inverse": (jse2.inverse, tse2.inverse, (_pose2,)),
    "se2_boxplus": (jse2.boxplus, tse2.boxplus, (_pose2, _pose2)),
    "se2_landmark_in_frame": (jse2.landmark_in_frame, tse2.landmark_in_frame,
                              (_pose2, _xy)),
    "project_p2c": (jcam.project_p2c, tcam.project_p2c,
                    (lambda r: 0.1 * _pose(r), _intrinsics, _point)),
    "cam_boxplus": (jba._cam_boxplus, tba._cam_boxplus,
                    (lambda r: np.concatenate([_pose(r), _intrinsics(r)], 1),
                     lambda r: 0.1 * _pose(r))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_manifold_function_matches_jax(name):
    jfn, tfn, makers = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 11)
    args = [m(rng) for m in makers]
    want = np.asarray(jax.vmap(jfn)(*[jnp.asarray(a) for a in args]))
    got = tfn(*[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float64
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(jlosses.LOSSES))
def test_robust_weight_matches_jax(name):
    """IRLS weights on |x| from 0 through every loss's knees to the tails."""
    x = np.concatenate([[0.0, 1e-40, 1.345, 2.385, 4.685, 1.5, 3.5, 8.0],
                        np.random.default_rng(5).uniform(0, 12, 249)])
    want = np.asarray(jlosses.LOSSES[name](jnp.asarray(x)))
    got = tlosses.LOSSES[name](torch.from_numpy(x))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
