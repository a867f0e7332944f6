"""Port parity for the geometry modules (geometry/*): the JAX package's
test_geometry.py cases through both packages on the same numpy inputs,
float64 on the CPU — minimal solvers, triangulation and distortion equal
to 1e-10; the batched closed-form polynomial roots with equal root
counts; the batched Kabsch structure average."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from slam_plus_plus_tpu.geometry import distortion as jdist
from slam_plus_plus_tpu.geometry import minimal as jmin
from slam_plus_plus_tpu.geometry import polynomial as jpoly
from slam_plus_plus_tpu.geometry import struct_average as jsa
from slam_plus_plus_tpu.geometry import triangulate as jtri
from slam_plus_plus_tpu_torch.geometry import distortion as tdist
from slam_plus_plus_tpu_torch.geometry import minimal as tmin
from slam_plus_plus_tpu_torch.geometry import polynomial as tpoly
from slam_plus_plus_tpu_torch.geometry import struct_average as tsa
from slam_plus_plus_tpu_torch.geometry import triangulate as ttri

TOL = 1e-10


def _rand_pose(rng):
    aa = rng.normal(0, 0.5, 3)
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    t = rng.normal(0, 1.0, 3) + np.array([0, 0, 4.0])
    return R, t


def _two_views(seed, n, depth=6.0):
    rng = np.random.default_rng(seed)
    R, t = _rand_pose(rng)
    pts = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, depth])
    pc2 = pts @ R.T + t
    return R, t, pts, pts[:, :2] / pts[:, 2:3], pc2[:, :2] / pc2[:, 2:3]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1.0)


def _same_solutions(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            for gi, wi in zip(g, w):
                _close(gi, wi)
        else:
            _close(g, w)


def _case_p3p():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(20):
        R, t = _rand_pose(rng)
        pts = rng.uniform(-2, 2, (3, 3))
        pc = pts @ R.T + t
        if (pc[:, 2] <= 0.3).any():
            continue
        out.append((pc / np.linalg.norm(pc, axis=1, keepdims=True), pts))
    return [(m.p3p, args) for m in (jmin, tmin) for args in out]


def _cases(name):
    if name == "essential_8pt":
        R, t, _, x1, x2 = _two_views(8, 30)
        return [(m.essential_8pt, (x1, x2)) for m in (jmin, tmin)]
    if name == "decompose_essential":
        R, t, _, x1, x2 = _two_views(8, 30)
        E = jmin.essential_8pt(x1, x2)
        return [(m.decompose_essential, (E, x1, x2)) for m in (jmin, tmin)]
    if name == "essential_5pt":
        R, t, _, x1, x2 = _two_views(3, 5, depth=4.0)
        return [(m.essential_5pt, (x1, x2)) for m in (jmin, tmin)]
    if name == "homography_dlt":
        rng = np.random.default_rng(9)
        H = np.array([[1.1, 0.02, 0.3], [-0.03, 0.95, -0.2], [0.001, 0.002, 1.0]])
        x1 = rng.uniform(-1, 1, (12, 2))
        x2h = np.concatenate([x1, np.ones((12, 1))], axis=1) @ H.T
        return [(m.homography_dlt, (x1, x2h[:, :2] / x2h[:, 2:3])) for m in (jmin, tmin)]
    if name == "triangulate_two_view":
        R, t, _, x1, x2 = _two_views(10, 15)
        return [(m.triangulate_two_view, (np.eye(3), np.zeros(3), R, t, x1, x2))
                for m in (jtri, ttri)]
    if name == "triangulate_nview":
        R, t, _, x1, x2 = _two_views(10, 15)
        return [(m.triangulate_nview, ([np.eye(3), R], [np.zeros(3), t], [x1[0], x2[0]]))
                for m in (jtri, ttri)]
    intr = np.array([500.0, 510.0, 320.0, 240.0, 1.0e-6 * 505.0])
    uv = np.random.default_rng(11).uniform(0, 1, (50, 2)) * np.array([640, 480])
    if name == "distort":
        return [(m.distort, (uv, intr)) for m in (jdist, tdist)]
    d = jdist.distort(uv, intr)
    return [(lambda a, b, m=m: m.undistort(a, b, iters=20), (d, intr)) for m in (jdist, tdist)]


@pytest.mark.parametrize("name", [
    "p3p", "essential_8pt", "decompose_essential", "essential_5pt", "homography_dlt",
    "triangulate_two_view", "triangulate_nview", "distort", "undistort"])
def test_host_geometry_matches_jax(name):
    cases = _case_p3p() if name == "p3p" else _cases(name)
    half = len(cases) // 2
    hits = 0
    for (jf, args), (tf, targs) in zip(cases[:half], cases[half:]):
        want, got = jf(*args), tf(*targs)
        if isinstance(want, (list, tuple)):
            _same_solutions(list(got), list(want))
            hits += len(want)
        else:
            _close(got, want)
            hits += 1
    assert hits > 0


def test_decompose_recovers_the_pose():
    R, t, _, x1, x2 = _two_views(8, 30)
    R2, t2 = tmin.decompose_essential(tmin.essential_8pt(x1, x2), x1, x2)
    assert np.abs(R2 - R).max() < 1e-6
    tn = t / np.linalg.norm(t)
    assert min(np.abs(t2 - tn).max(), np.abs(t2 + tn).max()) < 1e-6


def _roots_equal(got, want):
    (gr, gc), (wr, wc) = got, want
    gr, wr = gr.numpy(), np.asarray(wr)
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(np.isnan(gr), np.isnan(wr))
    ok = ~np.isnan(wr)
    scale = np.maximum(np.abs(wr[ok]), 1.0)
    assert np.all(np.abs(gr[ok] - wr[ok]) <= TOL * scale)


def test_quadratic_roots_match_jax():
    rng = np.random.default_rng(3)
    a, b, c = rng.normal(size=(3, 256))
    a[:8] = 0.0            # the linear fallback
    b[:4] = 0.0            # and its degenerate case
    c[8:16] = 0.0
    _roots_equal(tpoly.quadratic_roots(a, b, c), jpoly.quadratic_roots(a, b, c))


def test_cubic_and_quartic_roots_match_jax():
    rng = np.random.default_rng(4)
    co = rng.normal(size=(4, 256))
    co[0] += np.sign(co[0]) * 0.5
    _roots_equal(tpoly.cubic_roots(*co), jpoly.cubic_roots(*co))
    tr, _ = tpoly.cubic_roots(*co)
    jr, _ = jpoly.cubic_roots(*co)
    _close(np.nan_to_num(tpoly.polish_roots(np.stack(co, -1), tr).numpy()),
           np.nan_to_num(np.asarray(jpoly.polish_roots(np.stack(co, -1), jr))))
    co4 = np.stack([np.poly(np.sort(rng.normal(size=4) * 2)) for _ in range(64)], -1)
    co4[:, 32:] = rng.normal(size=(5, 32))          # some with complex roots
    _roots_equal(tpoly.quartic_roots(*co4), jpoly.quartic_roots(*co4))
    r, n = tpoly.quartic_roots(*co4[:, :32])
    assert (n.numpy() == 4).all()
    got = np.sort(tpoly.polish_roots(co4[:, :32].T, r).numpy(), axis=1)
    want = np.stack([np.sort(np.roots(co4[:, i]).real) for i in range(32)])
    assert np.allclose(got, want, atol=1e-5)


def test_cbrt_at_negative_arguments_and_zero():
    x = np.array([-27.0, -8.0, -1e-300, -0.125, 0.0, -0.0, 1e-12, 8.0, 3.375e12])
    got = tpoly.cbrt(torch.as_tensor(x)).numpy()
    # |x|^(1/3) is within a few ulps of the cube root; at 1e-300 the pow
    # of a tiny argument loses 1.3e-14 relative
    assert np.allclose(got, np.cbrt(x), rtol=2e-14, atol=0)
    assert np.array_equal(np.sign(got), np.sign(x))
    assert got[4] == 0.0 and got[5] == 0.0


def test_polyfit_and_companion_match_jax():
    rng = np.random.default_rng(3)
    x = np.linspace(-2, 2, 200)
    y = 0.5 * x**3 - x + 2 + rng.normal(0, 0.01, 200)
    y[::20] += 50.0
    for kw in (dict(loss="huber", scale=0.1), {}):
        _close(tpoly.polyfit_robust(x, y, 3, **kw).numpy(),
               np.asarray(jpoly.polyfit_robust(x, y, 3, **kw)))
    assert np.allclose(tpoly.polyfit_robust(x, y, 3, loss="huber", scale=0.1).numpy(),
                       [0.5, 0.0, -1.0, 2.0], atol=0.05)
    c = [1.0, 0, 0, 0, 0, -32.0]
    assert np.array_equal(tpoly.roots_companion(c), jpoly.roots_companion(c))


def test_struct_average_matches_jax():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(40, 3))
    base -= base.mean(axis=0)
    flat = []
    for k in range(6):
        R = Rotation.random(random_state=k).as_matrix()
        flat.append(base @ R.T + rng.normal(size=3) * 5 + rng.normal(0, 0.01, (40, 3)))
    flat = np.concatenate(flat)
    want = jsa.average_structure_np(flat, 40)
    _close(tsa.average_structure_np(flat, 40, device="cpu"), want)
    _close(tsa.average_structure(flat.reshape(6, 40, 3)).numpy(), want)
    expect = base @ Rotation.random(random_state=0).as_matrix().T
    assert np.abs(want - (expect - expect.mean(axis=0))).max() < 0.02
