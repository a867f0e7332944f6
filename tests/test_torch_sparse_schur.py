"""Port parity for the sparse-reduced Schur branch (linalg/schur.py): the host
plan, the clique and the gathered numeric paths, the routing rule, and LM
through the branch, against the JAX package on the CPU in float64.

The scene is the JAX package's own (tests/test_schur.py): 24 cameras, 400
points seen by 6 cameras each, damped at 1e-3 x max diag; the branch is
forced with sparse_reduced_limit=1."""

import numpy as np
import pytest
import torch

import jax

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.schur import SchurSolver as JSchur
from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slam_plus_plus_tpu.solvers.lm import damp_system as jdamp
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver as TSchur
from slam_plus_plus_tpu_torch.linalg.schur import route_sparse_reduced
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver as TLM
from slam_plus_plus_tpu_torch.utils import timer


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    cams, pts, obs = jds.make_ba_scene_large(n_cams=24, n_points=400, obs_per_point=6,
                                             seed=5)
    p = str(tmp_path_factory.mktemp("sparse_schur") / "clq.g2o")
    jds.write_g2o_ba(p, cams, pts, obs)
    js = jparse(p)
    ja = JAssembler(js, SolverConfig())
    jb = ja.assemble(ja.snapshot_states(js))
    jb = jdamp(jb, float(jb.max_hdiag) * 1e-3, ja.pp_diag_ids_dev)
    ta = TAssembler(tparse(p), device="cpu")
    # the same damped lambda on both sides
    tb = BlockSystem(*[torch.as_tensor(np.array(x)) for x in jb])
    return p, ja, jb, ta, tb


def test_plan_arrays_equal(scene):
    _p, ja, _jb, ta, _tb = scene
    jsch, tsch = JSchur(ja, sparse_reduced_limit=1), TSchur(ta, sparse_reduced_limit=1)
    assert jsch.sparse_reduced and tsch.sparse_reduced
    assert not tsch.uniform
    assert jsch._clique_uniform is not None and tsch.clique
    assert tsch.M == jsch._clique_uniform["M"] == 6
    assert tsch.Ksc == jsch.Ksc
    for name in ("sc_rows", "sc_cols", "pp_to_sc", "fill_dst", "fill_pa", "fill_pb",
                 "fill_flip"):
        np.testing.assert_array_equal(getattr(tsch, name),
                                      np.asarray(getattr(jsch, "_" + name)), err_msg=name)
    np.testing.assert_array_equal(tsch._triu.numpy(),
                                  np.asarray(jsch._clique_uniform["triu"]))
    jplan, tplan = jsch._reduced_chol.plan, tsch.reduced_chol.plan
    assert tplan.n_bottom == jplan.n_bottom
    assert len(tplan.levels) == len(jplan.levels)


@pytest.mark.parametrize("path", ["clique", "gathered"])
def test_sparse_solve_matches_jax(scene, path):
    _p, ja, jb, ta, tb = scene
    jsch, tsch = JSchur(ja, sparse_reduced_limit=1), TSchur(ta, sparse_reduced_limit=1)
    if path == "gathered":
        jsch._clique_uniform = None
        tsch.clique = False
    want = jax.jit(jsch._solve_sparse_impl)(jb)
    # the clique path's solve goes through K3's entry points (on the CPU
    # their plain versions), the gathered path's through the torch chain
    timer.enable()
    try:
        got = tsch.solve(tb)
        counts = [c.name for c in timer.drain()["counts"]]
    finally:
        timer.disable()
    assert counts.count("schur.clique.plain") == (path == "clique")
    dense = TSchur(ta).solve(tb)        # the port's dense uniform solve
    assert not TSchur(ta).sparse_reduced
    for w, g, d in zip(want, got, dense):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-9)
        assert np.abs(g.numpy() - w).max() <= 1e-10 * scale
        assert np.abs(g.numpy() - d.numpy()).max() <= 1e-8 * scale


class _Routed(Exception):
    pass


class _Sizes:
    """An assembler stand-in with only the sizes routing reads: the JAX
    SchurSolver's first read of anything else means it went dense."""

    def __init__(self, Np, Bp, Nl, Bl, Kpl):
        self.Np, self.Bp, self.Nl, self.Bl, self.Kpl = Np, Bp, Nl, Bl, Kpl

    def __getattr__(self, name):
        raise _Routed("dense")


def _jax_route(monkeypatch, sizes, **kw):
    def sparse(self):
        raise _Routed("sparse")

    monkeypatch.setattr(JSchur, "_build_sparse_reduced", sparse)
    with pytest.raises(_Routed) as e:
        JSchur(_Sizes(*sizes), **kw)
    return str(e.value) == "sparse"


@pytest.mark.parametrize("sizes, kw", [
    ((100, 6, 8000, 3, 608000), {}),            # bench scene: dense uniform
    ((871, 6, 100000, 3, 800000), {}),          # venice-real: sparse (panels)
    ((871, 6, 100000, 3, 800000), {"dense_reduced": True}),
    ((4000, 6, 3000, 3, 30000), {}),            # reduced system past the limit
    ((100, 6, 8000, 3, 608000), {"sparse_reduced_limit": 1}),
])
def test_routing_matches_jax(monkeypatch, sizes, kw):
    assert route_sparse_reduced(*sizes, **kw) == _jax_route(monkeypatch, sizes, **kw)
    if sizes[0] == 871 and not kw:
        assert route_sparse_reduced(*sizes)


def _jax_lm_trajectory(path, **schur_kw):
    """The JAX LM run forced through the sparse branch: (final chi2,
    iterations, trial chi2s), read off its one device_get per trial."""
    log = []
    real_get = jax.device_get

    def spy(x):
        out = real_get(x)
        if isinstance(x, tuple) and len(x) == 3:
            log.append(float(out[1]))
        return out

    jlm = JLM(jparse(path))
    jlm._schur = JSchur(jlm.asm, **schur_kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_get", spy)
        chi2, iters = jlm.optimize(5, 0.01)
    return chi2, iters, log


def test_lm_through_the_sparse_branch(scene):
    path = scene[0]
    jchi2, jit, jlog = _jax_lm_trajectory(path, sparse_reduced_limit=1)
    tlm = TLM(tparse(path), device="cpu")
    tlm._schur = TSchur(tlm.asm, sparse_reduced_limit=1)
    assert tlm._schur.sparse_reduced and tlm._schur.clique
    tchi2, tit = tlm.optimize(5, 0.01)
    assert tit == jit == 5
    for (_n, te, _d), je in zip(tlm.trial_log, jlog):
        assert abs(te - je) <= 1e-9 * je
    assert abs(tchi2 - jchi2) <= 1e-9 * jchi2
