"""Port parity for the Sim(3) and ROCV families and the last parser and
generator pieces, float64 on the CPU, against the JAX package on the same
seeded numpy input: sim3's exp / log / compose on the small-θ, small-λ and
general branches; GN on a Sim(3) chain and LM on an inverse-distance Sim(3)
BA scene; the ROCV file (writer bytes, parsed system, GN trajectory);
``use_vertex_init``; and the garage generator.  (Each Sim(3) edge type is
held against JAX's jacfwd in tests/test_torch_sim3_edges.py.)

Tolerances (each x scale): 1e-10 for float64 arithmetic done the same way
in both packages; 1e-8 for anything that passes through sim3.log's linear
solve, and for a GN or LM trajectory, whose steps pass through two
packages' factorizations."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.graph.system import GraphSystem as JSystem
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.manifolds import sim3 as jsim3
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver as JGN
from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slam_plus_plus_tpu_torch.graph.system import GraphSystem as TSystem
from slam_plus_plus_tpu_torch.io import datasets as tds
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.manifolds import sim3 as tsim3
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver as TGN
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver as TLM
from test_torch_io import _assert_same_system

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
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


#: sim(3) tangents [u, w, lambda] on each branch of _w_matrix
TANGENTS = {
    "general": [0.3, -0.2, 0.5, 0.4, -0.3, 0.2, 0.25],
    "small_theta": [0.3, -0.2, 0.5, 1e-6, -2e-6, 1e-6, 0.25],
    "small_lambda": [0.3, -0.2, 0.5, 0.4, -0.3, 0.2, 3e-10],
    "both_small": [0.3, -0.2, 0.5, 1e-6, -2e-6, 1e-6, -3e-10],
}


@pytest.mark.parametrize("branch", sorted(TANGENTS))
def test_sim3_math_matches(branch):
    rng = np.random.default_rng(sorted(TANGENTS).index(branch))
    xi = np.asarray(TANGENTS[branch]) * (1 + 0.1 * rng.normal(size=(5, 7)))
    other = np.concatenate([rng.normal(0, 1, (5, 3)), rng.normal(0, 0.5, (5, 3)),
                            rng.uniform(0.5, 2.0, (5, 1))], axis=1)
    pts = rng.normal(0, 2, (5, 3))
    J = {name: jax.vmap(getattr(jsim3, name)) for name in
         ("exp", "log", "compose", "inverse", "relative_to", "boxplus", "transform_point")}
    t = torch.from_numpy
    p = np.asarray(J["exp"](jnp.asarray(xi)))
    assert _rel(tsim3.exp(t(xi)), p) <= F64_TOL
    assert _rel(tsim3.log(t(p)), J["log"](jnp.asarray(p))) <= SOLVE_TOL
    assert _rel(tsim3.log(t(p)), xi) <= SOLVE_TOL                 # log inverts exp
    for name in ("compose", "relative_to", "boxplus"):
        b = xi if name == "boxplus" else p
        want = J[name](jnp.asarray(other), jnp.asarray(b))
        assert _rel(getattr(tsim3, name)(t(other), t(b)), want) <= F64_TOL, name
    assert _rel(tsim3.inverse(t(other)), J["inverse"](jnp.asarray(other))) <= F64_TOL
    assert _rel(tsim3.transform_point(t(other), t(pts)),
                J["transform_point"](jnp.asarray(other), jnp.asarray(pts))) <= F64_TOL
    # forward-mode Jacobian of the retraction at delta = 0 is finite
    zero = torch.zeros((5, 7), dtype=torch.float64)
    _, tangent = torch.func.jvp(lambda d: tsim3.boxplus(t(other), d), (zero,), (t(xi),))
    assert torch.isfinite(tangent).all()


def _gn_trajectories(make, iters=5):
    """GN on both packages from the same scene (make(GraphSystem class) ->
    system): (JAX chi2 per linearization, final chi2, iterations), the
    port's, and the port's solver."""
    jgn = JGN(make(JSystem))
    jlog, assemble = [], jgn.asm.assemble

    def spy(states):
        bs = assemble(states)
        jlog.append(float(bs.chi2))
        return bs

    jgn.asm.assemble = spy
    jchi2, jit = jgn.optimize(iters)
    tgn = TGN(make(TSystem), device="cpu")
    chi2, it = tgn.optimize(iters)
    return (jlog, jchi2, jit), ([c for c, _ in tgn.iteration_log], chi2, it), tgn


def test_sim3_chain_gn_trajectory_matches():
    """The port's Sim(3) chain (io/datasets.py, built in code), the same
    numpy into both packages' GraphSystem."""
    lists = tds.make_sim3_chain()
    (jlog, jchi2, jit), (tlog, chi2, it), _ = _gn_trajectories(
        lambda cls: tds.fill_system(cls(), *lists))
    assert it == jit and len(tlog) == len(jlog)
    for g, w in zip(tlog, jlog):
        assert abs(g - w) <= SOLVE_TOL * w
    assert abs(chi2 - jchi2) <= SOLVE_TOL * jchi2 and chi2 < 0.05 * jlog[0]


def test_sim3_invdist_lm_trajectory_matches():
    """The port's inverse-distance Sim(3) BA (LS and LO edges; each camera's
    scale with its own points' inverse distances is a null direction of the
    undamped system, so LM, as the JAX package's test runs it): chi2 of
    every trial and the final chi2, through the Schur branch with Bl = 1."""
    lists = tds.make_sim3_invdist_ba()
    jlog, real_get = [], jax.device_get

    def spy(x):
        """The JAX LM's one read per trial: (|dx|, trial chi2, denominator)."""
        out = real_get(x)
        if isinstance(x, tuple) and len(x) == 3:
            jlog.append(tuple(float(v) for v in out))
        return out

    jlm = JLM(tds.fill_system(JSystem(), *lists))
    start = jlm.chi2()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_get", spy)
        jchi2, jit = jlm.optimize(5)
    tlm = TLM(tds.fill_system(TSystem(), *lists), device="cpu")
    chi2, it = tlm.optimize(5)
    assert tlm._schur is not None and tlm.asm.Nl == 20 and tlm.asm.Bl == 1
    assert it == jit and len(tlm.trial_log) == len(jlog) == it
    for (_n, e, _d), (_jn, je, _jd) in zip(tlm.trial_log, jlog):
        assert abs(e - je) <= SOLVE_TOL * je
    assert abs(chi2 - jchi2) <= SOLVE_TOL * jchi2 and chi2 < 0.05 * start


@pytest.fixture(scope="module")
def rocv_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("rocv")
    jp, tp = str(d / "j.g2o"), str(d / "t.g2o")
    jds.write_g2o_rocv(jp, *jds.make_rocv_scene(n_steps=40, seed=33))
    tds.write_g2o_rocv(tp, *tds.make_rocv_scene(n_steps=40, seed=33))
    return jp, tp


def test_rocv_writer_and_parser_match(rocv_file):
    jp, tp = rocv_file
    with open(jp, "rb") as fj, open(tp, "rb") as ft:
        assert fj.read() == ft.read()
    js, ts = jparse(jp), tparse(jp)
    _assert_same_system(js, ts)
    assert sorted(ts.edge_stores) == ["edge_landmark3d_prior", "edge_rocv_const_vel",
                                      "edge_rocv_range"]


def test_rocv_gn_trajectory_matches(rocv_file):
    """GN through the landmark split (the transmitters) and the prior's
    expectation/error pair: its chi2 is 0, its curvature counts."""
    path = rocv_file[0]
    (jlog, jchi2, jit), (tlog, chi2, it), tgn = _gn_trajectories(
        lambda cls: jparse(path) if cls is JSystem else tparse(path))
    assert tgn._schur is not None and tgn.asm.Nl == 6
    assert it == jit and len(tlog) == len(jlog)
    for g, w in zip(tlog, jlog):
        assert abs(g - w) <= SOLVE_TOL * w
    assert abs(chi2 - jchi2) <= SOLVE_TOL * jchi2


_INFO3 = "100 1 2 200 3 400"
_INFO6 = " ".join(["20 0 0 0 0 0 20 0 0 0 0 20 0 0 0 20 0 0 20 0 20"])


@pytest.mark.parametrize("text", [
    f"VERTEX2 0 1 2 0.5\nVERTEX2 1 2 2 0.7\nEDGE2 0 1 1.0 0.2 0.3 {_INFO3}\n"
    f"EDGE2 1 2 -0.5 1.0 -3.0 {_INFO3}\nVERTEX_SE2 2 5 5 5",
    f"VERTEX3 0 1 2 3 0.1 0.2 0.3\nVERTEX_SE3 1 0 1 0 0.5 -0.2 2.0\n"
    f"EDGE3 0 1 1 2 3 0.1 -0.2 2.9 {_INFO6}\nVERTEX_XYZ 4 1 2 3",
], ids=["se2", "se3"])
def test_use_vertex_init_matches(tmp_path, text):
    p = tmp_path / "v.g2o"
    p.write_text(text + "\n")
    js, ts = jparse(str(p), use_vertex_init=True), tparse(str(p), use_vertex_init=True)
    _assert_same_system(js, ts)
    first = ts.vertex_state(0)
    assert np.array_equal(first[:3], [1.0, 2.0, 0.5] if "VERTEX2" in text else [1.0, 2.0, 3.0])


def test_garage_generator_is_byte_identical(tmp_path):
    """The garage's relative poses come from each package's own se3."""
    jp, tp = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    _gt, edges = jds.make_garage_3d(n_loops=2, per_loop=60, seed=9)
    jds.write_g2o_3d_axisangle(jp, edges)
    _gt, edges = tds.make_garage_3d(n_loops=2, per_loop=60, seed=9)
    tds.write_g2o_3d_axisangle(tp, edges)
    with open(jp, "rb") as fj, open(tp, "rb") as ft:
        assert fj.read() == ft.read()
    _assert_same_system(jparse(jp), tparse(jp))
