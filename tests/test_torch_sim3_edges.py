"""Port parity for the Sim(3) edge grid, float64 on the CPU: each of the
JAX package's 31 Sim(3) edge types (reference Sim3_Types.h:247-3598), its
batched residual and its Jacobian per slot (forward mode through each
vertex's ⊞) against the JAX residual and jacfwd on the same states: the
JAX grid test's exact configurations, perturbed.

Tolerances (x scale): 1e-10, and 1e-8 for the pose-pose edge, whose
residual passes through sim3.log's linear solve."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.models.types import EDGE_TYPES as JEDGES
from slam_plus_plus_tpu.models.types import VERTEX_TYPES as JVERTS
from slam_plus_plus_tpu_torch.assembly.assembler import edge_jacobians
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES as TEDGES
from test_sim3_grid import OBSERVER, OWNER, _cases

F64_TOL = 1e-10
SOLVE_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _edge_cases():
    """(edge name, states (numpy), z) for every Sim(3) edge type: the JAX
    grid test's exact configurations, and the four types it leaves out."""
    cases = [(n, tuple(np.asarray(s) for s in st), np.asarray(z)) for n, st, z in _cases()]
    pw = np.array([0.4, -0.3, 5.0])
    lm_inv = np.array([0.1, -0.05, 0.2])
    nrm = np.linalg.norm([0.1, -0.05, 1.0])
    lm_dist = np.array([0.1 / nrm, -0.05 / nrm, 1.0 / nrm, 0.2])
    z2 = np.array([330.0, 250.0])
    z7 = np.array([0.5, -0.2, 0.1, 0.02, -0.01, 0.03, 1.02])
    cases += [("edge_pose_cam_sim3", (OWNER, OBSERVER), z7),
              ("edge_p2c_xyz_ls", (OWNER, pw), z2),
              ("edge_p2c_invdepth_ls", (OWNER, lm_inv), z2),
              ("edge_p2c_invdist_ls", (OWNER, lm_dist), z2)]
    return cases


_CASES = _edge_cases()


def test_every_sim3_edge_type_is_covered():
    """The cases cover every edge type of the JAX package's sim3_types."""
    from slam_plus_plus_tpu.models import sim3_types as jtypes
    from slam_plus_plus_tpu.models.types import EdgeType
    want = sorted(v.name for v in vars(jtypes).values() if isinstance(v, EdgeType))
    assert sorted(n for n, _s, _z in _CASES) == want and len(want) == 31


@pytest.mark.parametrize("name, states, z", _CASES, ids=[c[0] for c in _CASES])
def test_sim3_edge_residual_and_jacobian(name, states, z):
    """A batch of 3 perturbed copies of the configuration: the port's batched
    residual and Jacobians (forward mode through each vertex's ⊞) against
    the JAX residual and jacfwd, vmapped over the batch."""
    rng = np.random.default_rng(len(name))
    et, jet = TEDGES[name], JEDGES[name]
    batch = []
    for s, vt in zip(states, et.vertex_types):
        noise = rng.normal(0, 0.01, (3, len(s)))
        if vt in ("cam_sim3", "intrinsics"):
            noise[:, 7 if vt == "cam_sim3" else 0:] = 0.0      # constants stay
        batch.append(s[None, :] + noise)
    zb = np.broadcast_to(z, (3, len(z))).copy()
    tol = SOLVE_TOL if name == "edge_pose_cam_sim3" else F64_TOL
    tst = tuple(torch.from_numpy(b) for b in batch)
    jst = tuple(jnp.asarray(b) for b in batch)
    assert _rel(et.residual(tst, torch.from_numpy(zb)),
                jax.vmap(jet.residual)(jst, jnp.asarray(zb))) <= tol
    got = edge_jacobians(et, tst, torch.from_numpy(zb))
    for k, vt in enumerate(jet.vertex_types):
        jvt = JVERTS[vt]

        def jac(st, zj, k=k, jvt=jvt):
            def f(delta):
                s2 = list(st)
                s2[k] = jvt.boxplus(s2[k], delta)
                return jet.residual(tuple(s2), zj)
            return jax.jacfwd(f)(jnp.zeros(jvt.tangent_dim, dtype=zj.dtype))

        assert _rel(got[k], jax.vmap(jac)(jst, jnp.asarray(zb))) <= tol, (name, k)
