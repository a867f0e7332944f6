"""Port parity for the eigensolver (linalg/eigen.py) and the nested-Schur
analysis (linalg/nested_schur.py), float64 on the CPU: the dense route to
1e-10, "SM" to 1e-8, the port's own LOBPCG over LambdaSpmv (forced by
lowering _DENSE_LIMIT) against the dense oracle and the JAX package's
route at the JAX test's 1e-4, condition_estimate's block-Cholesky and PCG
routes within 5% of dense, and equal nested-Schur reports."""

import numpy as np
import pytest
import torch

import slam_plus_plus_tpu.models  # noqa: F401
import slam_plus_plus_tpu.linalg.eigen as JE
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.nested_schur import nested_schur_analysis as jnested
import slam_plus_plus_tpu_torch.linalg.eigen as TE
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.nested_schur import nested_schur_analysis as tnested
from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv


def _both(path):
    js, ts = jparse(path), tparse(path)
    ja, ta = JAssembler(js), TAssembler(ts, device="cpu")
    return ja, ja.assemble(ja.snapshot_states(js)), ta, ta.assemble(ta.snapshot_states(ts))


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eigen")
    out = {}
    for name, (n, seed, loop) in {"m50": (50, 70, None), "m40": (40, 71, None),
                                  "m300": (300, 72, None), "c300": (300, 3, 0.3)}.items():
        kw = {} if loop is None else dict(loop_prob=loop)
        poses, edges = jds.make_manhattan_2d(n_poses=n, seed=seed, **kw)
        out[name] = str(d / f"{name}.g2o")
        jds.write_g2o_2d(out[name], edges, poses)
    for name, (n, nl, seed) in {"l80": (80, 30, 73), "l20": (20, 8, 74)}.items():
        _gp, _gl, pe, le = jds.make_landmark_2d(n_poses=n, n_landmarks=nl, seed=seed)
        out[name] = str(d / f"{name}.g2o")
        jds.write_g2o_landmark_2d(out[name], pe, le)
    return out


def test_dense_lambda_equal(graphs):
    ja, jbs, ta, tbs = _both(graphs["l80"])
    assert np.abs(TE._dense_lambda(ta, tbs) - JE._dense_lambda(ja, jbs)).max() <= 1e-12 * \
        np.abs(JE._dense_lambda(ja, jbs)).max()


@pytest.mark.parametrize("which,name,k,tol", [("LM", "m50", 3, 1e-10), ("SM", "m40", 2, 1e-8)])
def test_dense_routes_match_jax(graphs, which, name, k, tol):
    ja, jbs, ta, tbs = _both(graphs[name])
    jw, jV = JE.sym_eigs(ja, jbs, k=k, which=which)
    tw, tV = TE.sym_eigs(ta, tbs, k=k, which=which)
    assert np.allclose(tw, jw, rtol=tol, atol=0)
    A = TE._dense_lambda(ta, tbs)
    for i in range(k):
        assert np.abs(A @ tV[:, i] - tw[i] * tV[:, i]).max() < 1e-6 * abs(tw[0])


def test_columns_spmv_equals_the_vector_spmv(graphs):
    """Both calls of LambdaSpmv against the dense lambda on a landmark
    graph (mirrored pose-pose blocks, pose-landmark and landmark blocks)."""
    _ja, _jbs, ta, tbs = _both(graphs["l80"])
    spmv = LambdaSpmv(ta)
    A = torch.as_tensor(TE._dense_lambda(ta, tbs))
    n_p = ta.Np * ta.Bp
    g = torch.Generator().manual_seed(0)
    V_p = torch.randn((ta.Np, ta.Bp, 3), generator=g, dtype=torch.float64)
    V_l = torch.randn((ta.Nl, ta.Bl, 3), generator=g, dtype=torch.float64)
    want = A @ torch.cat([V_p.reshape(n_p, 3), V_l.reshape(-1, 3)], dim=0)
    O_p, O_l = spmv.columns(tbs, V_p, V_l)
    assert torch.allclose(O_p.reshape(n_p, 3), want[:n_p], rtol=1e-13, atol=1e-9)
    assert torch.allclose(O_l.reshape(-1, 3), want[n_p:], rtol=1e-13, atol=1e-9)
    for j in range(3):
        o_p, o_l = spmv(tbs, V_p[:, :, j], V_l[:, :, j])
        assert torch.allclose(o_p.reshape(-1), want[:n_p, j], rtol=1e-13, atol=1e-9)
        assert torch.allclose(o_l.reshape(-1), want[n_p:, j], rtol=1e-13, atol=1e-9)


def test_lobpcg_matches_jax_on_a_matrix():
    from jax.experimental.sparse.linalg import lobpcg_standard as jlobpcg
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.normal(size=(60, 60)))
    A = (Q * np.geomspace(1.0, 1e4, 60)) @ Q.T
    X0 = rng.normal(size=(60, 4))
    jw, _, _ = jlobpcg(lambda X: jnp.asarray(A) @ X, jnp.asarray(X0), m=100)
    At = torch.as_tensor(A)
    tw, tV, it = TE.lobpcg_standard(lambda X: At @ X, torch.as_tensor(X0), m=100)
    assert np.allclose(tw.numpy(), np.asarray(jw), rtol=1e-10)
    assert np.allclose(tw.numpy(), np.linalg.eigvalsh(A)[::-1][:4], rtol=1e-10)
    assert 0 < it <= 100


def test_lobpcg_route_matches_dense_and_jax(graphs, monkeypatch):
    ja, jbs, ta, tbs = _both(graphs["m300"])
    ref = np.sort(np.abs(np.linalg.eigvalsh(TE._dense_lambda(ta, tbs))))[::-1]
    monkeypatch.setattr(TE, "_DENSE_LIMIT", 10)
    monkeypatch.setattr(JE, "_DENSE_LIMIT", 10)
    tw, tV = TE.sym_eigs(ta, tbs, k=3, which="LM")
    jw, _ = JE.sym_eigs(ja, jbs, k=3, which="LM")
    assert np.allclose(np.abs(tw), ref[:3], rtol=1e-4)
    assert np.allclose(tw, np.asarray(jw), rtol=1e-4)
    A = TE._dense_lambda(ta, tbs)
    for i in range(3):
        assert np.linalg.norm(A @ tV[:, i] - tw[i] * tV[:, i]) <= 1e-4 * abs(tw[i])


@pytest.mark.parametrize("name", ["c300", "l20"])
def test_condition_estimate_routes_within_5_percent(graphs, name, monkeypatch):
    """c300: pose-only, lambda^-1 through one block Cholesky factor; l20: a
    2D landmark graph, lambda^-1 by block-Jacobi PCG."""
    _ja, _jbs, ta, tbs = _both(graphs[name])
    assert (ta.Nl > 0) == (name == "l20")
    kappa_dense = TE.condition_estimate(ta, tbs)
    w = np.abs(np.linalg.eigvalsh(TE._dense_lambda(ta, tbs)))
    assert kappa_dense == pytest.approx(w.max() / w.min(), rel=1e-8)
    monkeypatch.setattr(TE, "_DENSE_LIMIT", 10)
    kappa = TE.condition_estimate(ta, tbs)
    assert abs(kappa - kappa_dense) / kappa_dense < 0.05, (kappa, kappa_dense)


@pytest.mark.parametrize("name", ["l80", "m300"])
def test_nested_schur_reports_equal(graphs, name):
    ja, _jbs, ta, _tbs = _both(graphs[name])
    report = tnested(ta)
    assert report == jnested(ja)
    assert report[0]["kind"] == "landmarks" and report[0]["eliminated"] == ta.Nl
    assert len(report) >= 2
