"""Port parity for the stereo, intrinsics, spheron and mixed BA families:
the generators and writers, the parsed stores, the assembled block system
(the generic per-edge Jacobian path in the flat layout), LM against the JAX
package's tests' anchors and the JAX package's own runs, and the CLI — all
on the CPU in float64."""

import numpy as np
import pytest
import torch

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app import main as jmain
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.manifolds import camera as jcam
from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.io import datasets as tds
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.manifolds import camera as tcam
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver as TLM


def _write(ds, family, path):
    """One family's file, written by the datasets module ds (the JAX
    package's or the port's) at the JAX tests' settings."""
    if family == "spheron":
        ds.write_g2o_spheron(path, *ds.make_spheron_scene(seed=32))
        return
    cams, pts, obs = ds.make_ba_scene(n_cams=8, n_points=150, seed=30)
    if family == "intrinsics":
        ds.write_g2o_ba_intrinsics(path, cams, pts, obs)
    elif family == "stereo":
        ds.write_g2o_ba_stereo(path, cams, pts, ds.make_ba_stereo_obs(cams, pts, seed=31))
    else:
        ds.write_g2o_ba_mixed(path, cams, pts, obs, ds.make_ba_stereo_obs(cams, pts, seed=31))


FAMILIES = ("intrinsics", "stereo", "spheron", "mixed")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ba_families")
    out = {}
    for fam in FAMILIES:
        out[fam] = (str(d / f"{fam}_jax.g2o"), str(d / f"{fam}_port.g2o"))
        _write(jds, fam, out[fam][0])
        _write(tds, fam, out[fam][1])
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_files_byte_equal(files, family):
    jp, tp = files[family]
    with open(jp, "rb") as fj, open(tp, "rb") as ft:
        assert fj.read() == ft.read()


def _same(a, b):
    """Nested tuples / lists / arrays equal element for element."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, type(a)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("gen, kw", [
    ("make_ba_scene_large", dict(n_cams=30, n_points=500, obs_per_point=5, seed=871)),
    ("make_spheron_scene", dict(seed=32)),
])
def test_generator_arrays_equal(gen, kw):
    assert _same(getattr(jds, gen)(**kw), getattr(tds, gen)(**kw))
    cams, pts, _obs = jds.make_ba_scene(n_cams=4, n_points=40, seed=3)
    assert _same(jds.make_ba_stereo_obs(cams, pts, seed=4),
                 tds.make_ba_stereo_obs(cams, pts, seed=4))


@pytest.mark.parametrize("family", FAMILIES)
def test_parsed_stores_equal(files, family):
    path = files[family][0]
    js, ts = jparse(path), tparse(path)
    assert sorted(js.vertex_stores) == sorted(ts.vertex_stores)
    for t in js.vertex_stores:
        assert np.array_equal(js.vertex_stores[t].data, ts.vertex_stores[t].data), t
        assert js.vertex_stores[t].global_ids == ts.vertex_stores[t].global_ids
    assert (js.vertex_order, js.vertex_directory, js._edge_insert_log) == \
        (ts.vertex_order, ts.vertex_directory, ts._edge_insert_log)
    assert sorted(js.edge_stores) == sorted(ts.edge_stores)
    for name, je in js.edge_stores.items():
        te = ts.edge_stores[name]
        assert je.n == te.n > 0
        for f in ("vertex_ids", "measurements", "informations"):
            assert np.array_equal(getattr(je, f)[:je.n], getattr(te, f)[:te.n]), (name, f)
    if family == "spheron":
        assert "xyz" in ts.vertex_stores      # points created from the edges


@pytest.mark.parametrize("family", FAMILIES)
def test_assembly_matches(files, family):
    """lambda/eta on both packages from the same states, the JAX package in
    its flat edge layout (which the port's generic path implements)."""
    path = files[family][0]
    js, ts = jparse(path), tparse(path)
    ja = JAssembler(js, SolverConfig(edge_layout="flat"))
    ta = TAssembler(ts, device="cpu")
    assert ta.pl_uniform is None and ta.Nl > 0 and ta.Bp == 6
    for attr in ("pp_rows", "pp_cols", "pl_rows", "pl_cols", "pp_diag_ids", "p_mask"):
        assert np.array_equal(getattr(ja, attr), getattr(ta, attr)), attr
    if family in ("intrinsics", "mixed"):
        # the padded intrinsics tangent (5 of Bp = 6) and its unit pivot
        assert not ta.p_mask.all()
    rng = np.random.default_rng(7)
    jst = ja.snapshot_states(js)
    # a perturbed point, so the gradients are not at their noise floor
    dx_p = rng.normal(0, 1e-3, (ja.Np, ja.Bp)) * ja.p_mask
    dx_l = rng.normal(0, 1e-2, (ja.Nl, ja.Bl))
    jst = ja.update(jst, dx_p, dx_l)
    tst = ta.states_from_numpy({k: np.asarray(v) for k, v in jst.items()})
    jb, tb = ja.assemble(jst), ta.assemble(tst)
    for field in jb._fields:
        w, g = np.asarray(getattr(jb, field)), getattr(tb, field)
        assert g.shape == w.shape, field
        assert np.abs(g.numpy() - w).max() <= 1e-10 * max(np.abs(w).max(), 1.0), field


#: the JAX tests' anchors (tests/test_model_families.py:24-62):
#: (initial chi2, its tolerance, final chi2 bound or exact value, iterations)
ANCHORS = {
    "intrinsics": (20520.957368, 1e-3, ("=", 20520.96, 0.01), 1),
    "stereo": (33066.64, 1.0, ("<", 140.0), None),
    "spheron": (None, None, ("<", 1.0), None),
    "mixed": (None, None, None, None),
}


@pytest.mark.parametrize("family", FAMILIES)
def test_lm_matches_jax_and_the_anchors(files, family):
    path = files[family][0]
    jchi2, jit = JLM(jparse(path)).optimize(5)
    lm = TLM(tparse(path), device="cpu")
    init, tol, final, iters = ANCHORS[family]
    if init is not None:
        assert abs(lm.chi2() - init) < tol
    chi2, it = lm.optimize(5)
    assert it == jit
    assert abs(chi2 - jchi2) <= 1e-9 * jchi2
    if iters is not None:
        assert it == iters
    if final is not None and final[0] == "=":
        assert abs(chi2 - final[1]) < final[2]
    elif final is not None:
        assert chi2 < final[1]


def test_cli_prints_the_same_chi2(files, capsys):
    path = files["stereo"][0]
    assert jmain.main(["-i", path, "-nb", "-dx", ""]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(("denormalized chi2 error:", "solver took"))]
    assert len(want) == 2
    assert tmain.main(["-i", path, "--device", "cpu", "-dx", ""]) == 0
    out = capsys.readouterr().out.splitlines()
    for line in want:
        assert line in out


def test_camera_functions_match():
    rng = np.random.default_rng(11)
    n = 16
    cam = np.concatenate([rng.normal(0, 0.3, (n, 3)), rng.normal(0, 0.2, (n, 3))], 1)
    intr = np.stack([rng.uniform(450, 550, n), rng.uniform(450, 550, n),
                     rng.uniform(300, 340, n), rng.uniform(220, 260, n),
                     rng.uniform(0.05, 0.2, n)], 1)
    pt = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    quat = rng.normal(0, 1, (n, 4))
    T = torch.from_numpy
    for k in range(n):
        np.testing.assert_allclose(tcam.project_p2sc(T(cam), T(intr), T(pt))[k].numpy(),
                                   np.asarray(jcam.project_p2sc(cam[k], intr[k], pt[k])),
                                   rtol=1e-13)
        np.testing.assert_allclose(tcam.project_spheron(T(cam), T(pt))[k].numpy(),
                                   np.asarray(jcam.project_spheron(cam[k], pt[k])), rtol=1e-13)
        for inv in (True, False):
            np.testing.assert_allclose(
                tcam.world_pose_to_cam(T(pt), T(quat), invert=inv)[k].numpy(),
                np.asarray(jcam.world_pose_to_cam(pt[k], quat[k], invert=inv)),
                rtol=1e-12, atol=1e-14)
        for w, g in zip(jcam.cam_to_world_pose(cam[k]), tcam.cam_to_world_pose(T(cam))):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)
