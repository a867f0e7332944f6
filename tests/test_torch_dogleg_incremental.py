"""Port parity for incremental BA, float64 on the CPU: the incremental
Lambda-DL (solvers/dogleg_incremental.py) and the marker-driven app
(app/incremental_ba.py) against the JAX package's on the same file, an
8-camera, 120-point scene written in chunks of 2 cameras (4 markers).  The
JAX package's dogleg keeps its trust radius across markers, the port's
restarts it at each marker (ROADMAP.md Queue 3); the JAX side's radius is
restarted the same way here, which on this scene leaves its chi2 trace as
it is.

Tolerances:
  * per-marker chi2 1e-9 relative, except the first marker at 1e-5: its
    two-camera SC has kappa 5.4e7 after the gauge ridge and is a
    difference of terms ~1e5 times larger, so the two packages' SCs at the
    same inputs already differ by 2.6e-11 relative, their GN steps by
    1e-5 and the chi2 after the step by 6.6e-7 (ROADMAP.md Queue 3); from
    the second marker on the trace agrees to ~1e-10;
  * the final states 1e-6 x scale (measured 4.8e-8 on the points): the
    first marker's difference lies along the scale gauge, which the
    thresholded updates never pull back (the final chi2 agrees to 1e-10);
    stats and the trust radius after every marker exactly;
  * the maintained lambda pieces and SC against a fresh assembly at the same
    states 1e-7 x scale (the JAX test's bound: the deltas are differences
    of large contributions);
  * the maintained-state marginals against the JAX package's 1e-6 x scale
    (the JAX package's own bound) at a gauge damping of 1e-6 x the largest
    Hessian diagonal (measured 1.0e-7, the states' gauge difference); at
    the app's default 1e-10 the Schur-domain inverse cancels (~1e-4 from
    the true Sigma in both packages, tests/test_torch_marginals.py), so the
    app's results there are held at 1e-3 (measured 1.3e-4) and the port's
    maintained marginals against its own batch Marginals at 1e-6
    (measured 8.4e-9);
  * the app's lambda branch: per-marker chi2 1e-9 (measured 2.9e-10), its
    marginals 1e-6 with the jitter set to 1e-6 in both packages.
"""

import numpy as np
import pytest
import torch

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.app import incremental_ba as JIBA
from slam_plus_plus_tpu.solvers import dogleg_incremental as jdl
from slam_plus_plus_tpu_torch.app import incremental_ba as TIBA
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.marginals import Marginals
from slam_plus_plus_tpu_torch.solvers import dogleg_incremental as tdl
from slam_plus_plus_tpu_torch.solvers.dogleg import INITIAL_TRUST_RADIUS, DoglegSolver


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capturing(cls, seen, restart=False):
    """A subclass of an IncrementalDoglegSolver that records its instance
    and the trust radius after every marker; restart: each marker's loop
    starts from the initial radius, as the port's does (the JAX package
    keeps the radius across markers, ROADMAP.md Queue 3)."""
    class Capturing(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.delta_trace = []
            seen.append(self)

        def optimize(self, *a, **k):
            if restart:
                self.delta = INITIAL_TRUST_RADIUS
            out = super().optimize(*a, **k)
            self.delta_trace.append(self.delta)
            return out
    return Capturing


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("iba") / "iba.g2o")
    cams, pts, obs = D.make_ba_scene(n_cams=8, n_points=120, seed=5)
    TIBA.write_incremental_ba(p, cams, pts, obs, cams_per_chunk=2)
    return p


@pytest.fixture(scope="module")
def replayed(path):
    """Both packages' run_incremental_ba(solver="dl", marginals=True), with
    their solvers kept; the JAX package's radius restarts at each marker,
    as the port's."""
    seen = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdl, "IncrementalDoglegSolver",
                   _capturing(jdl.IncrementalDoglegSolver, seen["jax"], restart=True))
        mp.setattr(tdl, "IncrementalDoglegSolver",
                   _capturing(tdl.IncrementalDoglegSolver, seen["port"]))
        jout = JIBA.run_incremental_ba(path, marginals=True)
        tout = TIBA.run_incremental_ba(path, device="cpu", marginals=True)
    return seen["jax"][0], jout, seen["port"][0], tout


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_markers_match_jax(path):
    """The edge count at each CONSISTENCY_MARKER, through each package's
    parser hook."""
    _js, jm = JIBA.parse_with_markers(path)
    ts, tm = TIBA.parse_with_markers(path)
    assert tm == jm and len(tm) == 4 and tm[-1] == ts.num_edges


def test_chi2_trace_matches_jax(replayed):
    js, (jfinal, jtrace, _jm), ts, (tfinal, ttrace, _tm) = replayed
    assert len(ttrace) == len(jtrace) == 4
    rel = np.abs(np.array(ttrace) - np.array(jtrace)) / np.array(jtrace)
    assert rel[0] <= 1e-5, rel
    assert rel[1:].max() <= 1e-9, rel
    assert abs(tfinal - jfinal) <= 1e-9 * jfinal


def test_final_states_match_jax(replayed):
    js, _j, ts, _t = replayed
    want = {t: np.asarray(v) for t, v in js._states.items()}
    got = ts.asm.states_to_numpy(ts._states)
    assert set(got) == set(want)
    for t in got:
        assert _rel(got[t], want[t]) <= 1e-6, (t, _rel(got[t], want[t]))


def test_stats_and_trust_radius_match_jax(replayed):
    js, _j, ts, _t = replayed
    for k in ("solves", "iters", "refreshed_edges", "refreshed_lms"):
        assert ts.stats[k] == js.stats[k], k
    assert ts.stats["iters"] > ts.stats["solves"]
    assert ts.delta_trace == js.delta_trace


def test_maintained_state_matches_a_fresh_assembly(replayed):
    """The maintained lambda pieces and the dense SC against a fresh
    assembly at the same states, after a replay with activations, pushes
    and landmark re-eliminations (the JAX test's invariant)."""
    _js, _j, s, _t = replayed
    bs = s.asm.assemble_active(s._states, s._counts, s._nap, s._nal)
    for name, ref in (("pp", bs.pp_blocks), ("u", bs.pl_blocks), ("ll", bs.ll_blocks),
                      ("eta_p", bs.eta_p), ("eta_l", bs.eta_l), ("sc", s._build_sc(bs))):
        assert _rel(s._M[name], ref) <= 1e-7, name


def test_marginals_match_jax(replayed):
    """The maintained-state marginals against the JAX package's at the same
    gauge damping, against the port's batch Marginals on a fresh assembly,
    and the app's results at its default damping."""
    js, (_f, _tr, jm), s, (_f2, _tr2, tm) = replayed
    bs = s.asm.assemble_active(s._states, s._counts, s._nap, s._nal)
    jbs = js.asm.assemble_active(js._states, js._counts, js._nap, js._nal)
    got = s.marginals(alpha=float(bs.max_hdiag) * 1e-6)
    want = js.marginals(alpha=float(jbs.max_hdiag) * 1e-6)
    assert _rel(got.p_diag, want[0]) <= 1e-6
    assert _rel(got.l_diag, want[1]) <= 1e-6
    got = s.marginals(alpha=float(bs.max_hdiag) * 1e-10)
    ref = Marginals(s.asm, gauge_jitter=1e-10).compute(bs)
    assert _rel(got.p_diag, ref.p_diag) <= 1e-6
    assert _rel(got.l_diag, ref.l_diag) <= 1e-6
    assert _rel(tm.p_diag, jm.p_diag) <= 1e-3
    assert _rel(tm.l_diag, jm.l_diag) <= 1e-3


def test_fluid_savings(replayed):
    """Fluid relinearization refreshes fewer edges than a full refresh
    every iteration would."""
    _js, _j, s, _t = replayed
    total = sum(p.E for p in s.asm.plans)
    assert 0 < s.stats["refreshed_edges"] < s.stats["iters"] * total


def test_converges_to_batch_quality(replayed, path):
    """The replay's final chi2 within 5% of the batch dogleg on the full
    problem (the JAX test's bound)."""
    _js, _j, _s, (final, _trace, _m) = replayed
    chi2_b, _ = DoglegSolver(TIBA.parse_with_markers(path)[0], device="cpu").optimize(20, 1e-3)
    assert final <= max(chi2_b, 1e-3) * 1.05


def test_lambda_branch_matches_jax(path):
    """run_incremental_ba(solver="lambda"): the active-prefix GN replay of
    the incremental lambda solver's own path, per-marker chi2 and the final
    marginals (the jitter set to 1e-6 in both packages) against the JAX
    package's."""
    import slam_plus_plus_tpu.marginals as jmarg
    import slam_plus_plus_tpu_torch.marginals as tmarg

    def jittered(cls):
        return lambda asm, gauge_jitter: cls(asm, gauge_jitter=1e-6)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmarg, "Marginals", jittered(jmarg.Marginals))
        mp.setattr(tmarg, "Marginals", jittered(tmarg.Marginals))
        jfinal, jtrace, jm = JIBA.run_incremental_ba(path, solver="lambda", marginals=True)
        tfinal, ttrace, tm = TIBA.run_incremental_ba(path, device="cpu", solver="lambda",
                                                     marginals=True)
    assert len(ttrace) == len(jtrace) == 4
    assert (np.abs(np.array(ttrace) - np.array(jtrace)) / np.array(jtrace)).max() <= 1e-9
    assert abs(tfinal - jfinal) <= 1e-9 * jfinal
    assert _rel(tm.p_diag, jm.p_diag) <= 1e-6
    assert _rel(tm.l_diag, jm.l_diag) <= 1e-6


def test_pose_graph_is_refused(tmp_path):
    poses, edges = D.make_manhattan_2d(n_poses=20, seed=3)
    p = str(tmp_path / "m.g2o")
    D.write_g2o_2d(p, edges, poses)
    with pytest.raises(ValueError, match="Schur-split"):
        tdl.IncrementalDoglegSolver(TIBA.parse_with_markers(p)[0], device="cpu")


def test_each_marker_restarts_the_trust_radius(path):
    """A marker's dogleg loop starts from the initial radius whatever the
    radius the previous marker ended at: a replay whose radius is set to
    1e12 before every marker (where the JAX package's persistent radius
    stands by the 10th marker of the bench scene) follows the plain replay
    exactly."""
    runs = []
    for preset in (None, 1e12):
        system, markers = TIBA.parse_with_markers(path)
        s = tdl.IncrementalDoglegSolver(system, device="cpu")
        trace = []
        for ms in (m - 1 for m in markers):
            s.advance_to(ms)
            if preset is not None:
                s.delta = preset
            trace.append(s.optimize())
        runs.append((trace, dict(s.stats), s.delta))
    assert runs[0] == runs[1]
    assert runs[0][1]["iters"] > runs[0][1]["solves"]
