"""Port parity: kernel K1's plain version against the JAX Pallas kernel (in
interpret mode), and the port's assembler against the JAX Assembler's
jacfwd path, float64 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig as JConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.ops.pallas_p2c import p2c_edge_terms as jp2c
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms

OUT_NAMES = ("chi2", "hdiag", "g_cam", "g_pt", "hcc", "hcp", "hpp")


def _p2c_inputs(E, seed):
    """[d, E] inputs: random cameras/points in front of the camera, a
    theta = 0 camera, a Taylor-branch camera and zero-info dummy edges."""
    rng = np.random.default_rng(seed)
    cam = np.zeros((11, E))
    cam[0:3] = rng.normal(0, 0.3, (3, E))
    cam[3:6] = rng.normal(0, 0.4, (3, E))
    cam[3:6, :16] = 0.0                      # theta = 0
    cam[3:6, 16:32] *= 1e-8                  # theta^2 < 1e-12
    cam[6:8] = rng.uniform(400, 600, (2, E))
    cam[8:10] = rng.uniform(300, 340, (2, E))
    cam[10] = rng.normal(0, 0.02, E) * cam[6:8].mean(0)
    pt = rng.uniform(-2, 2, (3, E))
    pt[2] += 6.0
    z = rng.uniform(0, 640, (2, E))
    a = rng.normal(0, 1, (2, 2, E))
    info = np.einsum("ikE,jkE->ijE", a, a).reshape(4, E) + np.array([1, 0, 0, 1.0])[:, None]
    info[:, -100:] = 0.0                     # dummy slots
    z[:, -100:] = 0.0
    return cam, pt, z, info


def test_p2c_plain_matches_pallas_interpret():
    args = _p2c_inputs(1024, seed=4)          # E a multiple of the Pallas TILE
    want = jp2c(*[jnp.asarray(a) for a in args], interpret=True)
    got = p2c_edge_terms(*[torch.from_numpy(a) for a in args])
    assert p2c_edge_terms.launches == 0       # CPU tensors never launch
    for name, w, g in zip(OUT_NAMES, want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(g.numpy() - w).max() <= 1e-10 * scale, name
    assert np.all(got[4][:, -100:].numpy() == 0.0)   # dummies contribute nothing


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cams, pts, obs = jds.make_ba_scene(n_cams=8, n_points=150, seed=12)
    p = str(tmp_path_factory.mktemp("p2c") / "ba.g2o")
    jds.write_g2o_ba(p, cams, pts, obs)
    js, ts = jparse(p), tparse(p)
    ja = JAssembler(js, JConfig(use_pallas="off"))
    ta = TAssembler(ts, device="cpu")
    jst = ja.snapshot_states(js)
    tst = ta.states_from_numpy({k: np.asarray(v) for k, v in jst.items()})
    return ja, ta, jst, tst


def test_host_plan_matches(pair):
    ja, ta, _, _ = pair
    for name in ("pp_rows", "pp_cols", "pl_rows", "pl_cols", "pp_diag_ids"):
        assert np.array_equal(getattr(ja, name), getattr(ta, name)), name
    assert (ja.Np, ja.Nl, ja.Bp, ja.Bl, ja.Kpp, ja.Kpl) == \
        (ta.Np, ta.Nl, ta.Bp, ta.Bl, ta.Kpp, ta.Kpl)
    assert ja.anchor_cslot == ta.anchor_cslot
    assert len(ja.pl_uniform) == len(ta.pl_uniform) == 1
    for jc, tc in zip(ja.pl_uniform, ta.pl_uniform):
        assert jc["M"] == tc["M"] and jc["offset"] == tc["offset"]
        assert np.array_equal(jc["rows"], tc["rows"])


def test_assembly_matches_jacfwd(pair):
    ja, ta, jst, tst = pair
    jb, tb = ja.assemble(jst), ta.assemble(tst)
    for name in jb._fields:
        w = np.asarray(getattr(jb, name))
        g = getattr(tb, name)
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(g.numpy() - w).max() <= 1e-9 * scale, name
    assert abs(float(ta.chi2(tst)) - float(ja.chi2(jst))) <= 1e-9 * float(ja.chi2(jst))


def test_update_matches(pair):
    ja, ta, jst, tst = pair
    rng = np.random.default_rng(3)
    dx_p = rng.normal(0, 0.05, (ja.Np, ja.Bp))
    dx_l = rng.normal(0, 0.05, (ja.Nl, ja.Bl))
    want = ja.update(jst, jnp.asarray(dx_p), jnp.asarray(dx_l))
    got = ta.update(tst, torch.from_numpy(dx_p), torch.from_numpy(dx_l))
    for t in want:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   rtol=0, atol=1e-12)
