"""Port parity: kernel K2's plain version against the JAX Pallas panel
kernel (interpret mode) and against SchurSolver._uniform_panels (the one-hot
einsum path), and the port's Schur solve against the JAX one, float64; the
kernel's tiling helper and the strided u4 view the solver hands it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.config import SolverConfig as JConfig
from slam_plus_plus_tpu.io import datasets as jds
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.schur import SchurSolver as JSchur
from slam_plus_plus_tpu.ops import planar as jplanar
from slam_plus_plus_tpu.ops.pallas_panel import build_panels as jbuild
from slam_plus_plus_tpu.solvers.lm import damp_system as jdamp
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler as TAssembler
from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem as TBlockSystem
from slam_plus_plus_tpu_torch.io.parser import parse_g2o as tparse
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver as TSchur
from slam_plus_plus_tpu_torch.ops import planar as tplanar
from slam_plus_plus_tpu_torch.linalg import schur as tschur_mod
from slam_plus_plus_tpu_torch.ops import panel as tpanel
from slam_plus_plus_tpu_torch.ops.panel import build_panels


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol,
                               equal_nan=True)


@pytest.mark.parametrize("B", [1, 2, 3, 4, 6])
def test_binv_matches(B):
    """Planar block inverse: adjugate for B <= 3, recursive Schur-complement
    inversion above (SPD blocks), float64, <= 1e-10 x scale."""
    rng = np.random.default_rng(B)
    a = rng.normal(0, 1, (50, B, B))
    spd = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(B)).reshape(50, B * B)
    want = np.asarray(jplanar.binv(jnp.asarray(spd), B))
    got = tplanar.binv(torch.from_numpy(spd), B)
    _close(got, want, 1e-10 * np.abs(want).max())
    v = rng.normal(0, 1, (50, B))
    _close(tplanar.bmv(got, torch.from_numpy(v), B, B),
           jplanar.bmv(jnp.asarray(want), jnp.asarray(v), B, B), 1e-10 * np.abs(want).max())


def test_panel_plain_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    Nl, M, Bl, Bp, n_cams = 16, 7, 3, 6, 10
    counts = rng.integers(2, M + 1, Nl)
    rows = np.argsort(rng.random((Nl, n_cams)), axis=1)[:, :M].astype(np.int32)
    u4 = rng.normal(0, 1, (Nl, M, Bl, Bp))
    for l in range(Nl):                        # dummy slots: camera 0, zero block
        rows[l, counts[l]:] = 0
        u4[l, counts[l]:] = 0.0
    rows[::3, 0] = 0                           # ... beside a real camera-0 slot
    assert any(counts[l] < M and 0 in rows[l, :counts[l]] for l in range(Nl))
    a = rng.normal(0, 1, (Nl, Bl, Bl))
    cinv = np.linalg.inv(a @ a.transpose(0, 2, 1) + np.eye(Bl)).reshape(Nl, Bl * Bl)
    want = jbuild(jnp.asarray(u4), jnp.asarray(rows), jnp.asarray(cinv), Bl, Bp,
                  n_cams, interpret=True)
    got = build_panels(torch.from_numpy(u4), torch.from_numpy(rows),
                       torch.from_numpy(cinv), Bl, Bp, n_cams)
    assert build_panels.launches == 0          # CPU tensors never launch
    _close(got[0], want[0], 1e-12)
    scale = np.abs(np.asarray(want[1])).max()
    _close(got[1], want[1], 1e-10 * scale)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("n_cams", [1, 100, 871, 5000])
def test_panel_tiling_covers_every_column_once(n_cams, itemsize):
    """The kernel's (landmarks per CTA, column window) choice at the bench's
    M = 76 and 3x6 blocks: its shared memory fits the budget, it has one
    accumulating thread per (landmark, i, j), and its windows cover every
    panel column exactly once."""
    Nl, M, Bl, Bp = 8000, 76, 3, 6
    TL, W = tpanel.panel_tiling(Nl, M, Bl, Bp, n_cams, itemsize)
    assert 1 <= TL and TL * Bl * Bp <= tpanel.PANEL_THREADS and 1 <= W <= n_cams
    assert tpanel.panel_smem_bytes(TL, W, M, Bl, Bp, itemsize) <= tpanel.PANEL_SMEM_BUDGET
    hits = np.zeros(n_cams * Bp, np.int64)
    for cam0, wc in tpanel.panel_windows(n_cams, W):
        assert 1 <= wc <= W
        hits[cam0 * Bp:(cam0 + wc) * Bp] += 1
    assert (hits == 1).all()
    if n_cams == 100:       # the bench shape: whole rows, one window
        assert W == n_cams
    if n_cams == 5000:      # too wide for one window in either dtype
        assert W < n_cams


def test_panel_tiling_past_the_budget():
    """Slots too many for the budget go up to the card's limit, then raise."""
    TL, W = tpanel.panel_tiling(10, 600, 3, 6, 50, 8)
    nbytes = tpanel.panel_smem_bytes(TL, W, 600, 3, 6, 8)
    assert tpanel.PANEL_SMEM_BUDGET < nbytes <= tpanel.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        tpanel.panel_tiling(10, 2000, 3, 6, 50, 8)


def _random_panel_inputs(seed, Nl, M, Bl, Bp, n_cams):
    rng = np.random.default_rng(seed)
    rows = np.argsort(rng.random((Nl, n_cams)), axis=1)[:, :M].astype(np.int32)
    counts = rng.integers(1, M + 1, Nl)
    pad = np.arange(M)[None] >= counts[:, None]
    rows[pad] = np.broadcast_to(rows[:, :1], rows.shape)[pad]   # edge 0's camera
    store = rng.normal(0, 1, (Nl, M, Bp, Bl))                   # H_pl blocks
    store[pad] = 0.0
    a = rng.normal(0, 1, (Nl, Bl, Bl))
    cinv = np.linalg.inv(a @ a.transpose(0, 2, 1) + np.eye(Bl)).reshape(Nl, Bl * Bl)
    return torch.from_numpy(store), torch.from_numpy(rows), torch.from_numpy(cinv)


def test_panel_plain_on_strided_view_is_bitwise():
    """The plain version on the solver's transposed view of the blocks gives
    the same bits as on a contiguous copy; the view is one the kernel reads
    in place, a broadcast one is not."""
    Nl, M, Bl, Bp, n_cams = 20, 9, 3, 6, 12
    store, rows, cinv = _random_panel_inputs(3, Nl, M, Bl, Bp, n_cams)
    view = store.transpose(2, 3)
    assert not view.is_contiguous() and tpanel._landmark_blocks_dense(view)
    assert not tpanel._landmark_blocks_dense(
        store[:, :1].expand(Nl, M, Bp, Bl).transpose(2, 3))
    got = build_panels(view, rows, cinv, Bl, Bp, n_cams)
    want = build_panels(view.contiguous(), rows, cinv, Bl, Bp, n_cams)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def ba(tmp_path_factory):
    cams, pts, obs = jds.make_ba_scene(n_cams=10, n_points=300, seed=5)
    p = str(tmp_path_factory.mktemp("panel") / "ba.g2o")
    jds.write_g2o_ba(p, cams, pts, obs)
    js, ts = jparse(p), tparse(p)
    ja = JAssembler(js, JConfig(use_pallas="off"))
    ta = TAssembler(ts, device="cpu")
    jb = ja.assemble(ja.snapshot_states(js))
    # the port solves from the JAX block system, so panels compare exactly
    tb = TBlockSystem(*[torch.tensor(np.asarray(x)) for x in jb])
    return ja, ta, jb, tb


def test_panels_match_uniform_einsum(ba, monkeypatch):
    """The undamped panels of a whole scene against the JAX einsum path,
    every landmark: C^-1 bitwise, Ut <= 1e-12 abs, Wt <= 1e-10 x scale with
    equal_nan.  A landmark seen by no camera has a zero pivot (NaN in both);
    one seen by a single camera has a rank-2 pivot (cond ~1e17), whose C^-1
    is rounding noise -- both sum Wt's rows in the same order, so even those
    agree."""
    ja, ta, jb, tb = ba
    monkeypatch.setenv("SLAMPP_PALLAS_PANELS", "0")
    jsch, tsch = JSchur(ja), TSchur(ta)
    assert jsch.panel_mode == "uniform"
    # some landmark's dummy slots repeat a camera it really sees
    M = ta.pl_uniform[0]["M"]
    rows = ta.pl_uniform[0]["rows"].reshape(ta.Nl, M)
    counts = ta.pl_uniform[0]["counts"]
    assert any(c < M and rows[l, M - 1] in rows[l, :c]
               for l, c in enumerate(counts))
    assert (counts == 0).any() and (counts == 1).any()
    c0, Ut0, Wt0 = jsch._uniform_panels(jb)
    c1, Ut1, Wt1 = tsch._uniform_panels(tb)
    assert np.isnan(np.asarray(c0)).any()
    assert np.array_equal(c1.numpy(), np.asarray(c0), equal_nan=True)
    _close(Ut1, Ut0, 1e-12)
    _close(Wt1, Wt0, 1e-10 * np.nanmax(np.abs(np.asarray(Wt0))))


def test_uniform_panels_read_blocks_in_place(ba, monkeypatch):
    """SchurSolver._uniform_panels hands K2 a view of the system's H_pl
    blocks, no copy, and still matches the JAX einsum path at the tolerances
    above (C^-1 bitwise, Ut 1e-12, Wt 1e-10 x scale)."""
    ja, ta, jb, tb = ba
    monkeypatch.setenv("SLAMPP_PALLAS_PANELS", "0")
    seen = []

    def spy(u4, *args):
        seen.append(u4)
        return build_panels(u4, *args)

    monkeypatch.setattr(tschur_mod, "build_panels", spy)
    c0, Ut0, Wt0 = JSchur(ja)._uniform_panels(jb)
    c1, Ut1, Wt1 = TSchur(ta)._uniform_panels(tb)
    (u4,) = seen
    assert not u4.is_contiguous()
    assert u4.untyped_storage().data_ptr() == tb.pl_blocks.untyped_storage().data_ptr()
    assert np.array_equal(c1.numpy(), np.asarray(c0), equal_nan=True)
    _close(Ut1, Ut0, 1e-12)
    _close(Wt1, Wt0, 1e-10 * np.nanmax(np.abs(np.asarray(Wt0))))


def test_panels_match_pallas_interpret_on_scene(ba):
    """K2's plain version against the JAX Pallas panel kernel (interpret
    mode) on the same undamped scene and the same C^-1.  XLA rounds the
    Pallas recombination differently in the last bit; on a landmark seen by
    a single camera (finite cond >= 1e12) C^-1 amplifies that bit to O(1),
    so Wt is compared on every other landmark, the singular ones included
    (NaN in both)."""
    ja, ta, jb, tb = ba
    jsch = JSchur(ja)
    c_inv = jplanar.binv(jb.ll_blocks, ta.Bl)
    want = jsch._uniform_panels_pallas(jb, c_inv)
    M, Nl, Bl, Bp = ta.M, ta.Nl, ta.Bl, ta.Bp
    u4 = tb.pl_blocks.reshape(Nl, M, Bp, Bl).transpose(2, 3).contiguous()
    rows = torch.from_numpy(ta.pl_uniform[0]["rows"].reshape(Nl, M).astype(np.int32))
    got = build_panels(u4, rows, torch.tensor(np.asarray(c_inv)), Bl, Bp, ta.Np)
    _close(got[0], want[0], 1e-12)
    ll = np.asarray(jb.ll_blocks).reshape(-1, Bl, Bl)
    with np.errstate(all="ignore"):
        cond = np.linalg.cond(ll)
    near = np.isfinite(cond) & (cond >= 1e12)
    counts = ta.pl_uniform[0]["counts"]
    assert near.any() and (counts[near] == 1).all()
    w = np.asarray(want[1]).reshape(Nl, -1)[~near]
    g = got[1].reshape(Nl, -1)[torch.from_numpy(~near)]
    assert np.isnan(w).any()
    _close(g, w, 1e-10 * np.nanmax(np.abs(w)))


def test_schur_solve_matches(ba):
    ja, ta, jb, tb = ba
    alpha = 1e-3 * float(jb.max_hdiag)
    jd = jdamp(jb, jnp.asarray(alpha), ja.pp_diag_ids_dev)
    td = TBlockSystem(*[torch.tensor(np.asarray(x)) for x in jd])
    want = JSchur(ja).solve(jd)
    got = TSchur(ta).solve(td)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        _close(g, w, 1e-9 * max(np.abs(w).max(), 1.0))
