"""The uniform dense Schur branch at the benchmark configuration ba-ring89
(BAL Venice-89's counts, every track 5 long): the layout and routing rules
that put it on K2's panels, the branch's spans and counters, and K2's least
work by real observations.

The ``card`` test holds K2 at the configuration's full shape bitwise to its
plain version; it skips without a card and runs there by

    python -m pytest --noconftest -m card tests/test_torch_dense_schur_cell.py

(the repository's conftest imports JAX, which the card's machine lacks).
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import drivers, roofline
from benchmark.panel_work import panel_work
from benchmark.scenes import ba_large
from benchmark.spec import Spec
from slam_plus_plus_tpu_torch.assembly import assembler
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg import schur
from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver, route_sparse_reduced, schur_route
from slam_plus_plus_tpu_torch.ops import panel, planar
from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver
from slam_plus_plus_tpu_torch.utils import timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the blocks of mono BA: camera 6, point 3
BP, BL = 6, 3


def _params(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)["scene"]["params"]


def _shape(name):
    """(Np, Nl, observations) of a ba_large configuration."""
    p = _params(name)
    return p["n_cams"], p["n_points"], p["n_points"] * p["obs_per_point"]


@pytest.fixture(autouse=True)
def _tracer_off():
    timer.disable()
    timer.drain()
    yield
    timer.disable()
    timer.drain()


@pytest.mark.parametrize("name, route", [("ba-ring89", "uniform"), ("ba-ring871", "sparse")])
def test_configuration_takes_its_schur_route(name, route):
    """ba-ring89: 534 dims, panels of 1.42 GB (under UNIFORM_PANEL_BYTES,
    1.61 GB) at a block density of 5.6%, so K2's branch; ba-ring871: 5,226
    dims, 66.2 GB of panels at 0.57%, so the sparse-reduced branch."""
    Np, Nl, n_obs = _shape(name)
    panel_bytes = 2 * Nl * BL * Np * BP * 4
    assert route_sparse_reduced(Np, BP, Nl, BL, n_obs) == (route == "sparse")
    assert schur_route(Np, BP, Nl, BL, n_obs, 1) == route
    if route == "uniform":
        assert panel_bytes <= schur.UNIFORM_PANEL_BYTES < 2 << 30
        # two channels of the uniform layout, or no uniform layout: the flat branch
        assert schur_route(Np, BP, Nl, BL, n_obs, 2) == "flat"
        assert schur_route(Np, BP, Nl, BL, n_obs, 0) == "flat"
    else:
        assert panel_bytes > 2 << 30 and n_obs / (Nl * Np) < 0.05


@pytest.mark.parametrize("n_obs, longest, uniform", [
    (None, 5, True),        # ba-ring89's scene: every track 5 long
    (562_976, 7, True),     # Venice-89's published count, no track past 7
    (562_976, 8, False),    # one track of 8 or more: the flat layout
])
def test_uniform_layout_needs_short_tracks(n_obs, longest, uniform):
    """At Venice-89's 110,973 points the uniform layout, which K1 and K2's
    branch need, admits no track longer than 7: the generator's constant
    degree is what puts ba-ring89 there; the published problem's long
    tracks would take the flat layout and the flat Schur."""
    _, Nl, scene_obs = _shape("ba-ring89")
    E = scene_obs if n_obs is None else n_obs
    assert assembler.uniform_padding_fits(E, Nl * longest) == uniform


@pytest.fixture(scope="module")
def ring89_small(tmp_path_factory):
    """A ba_large scene of ba-ring89's kind at test size (16 cameras, 300
    points, 5 observations each), as a g2o file."""
    params = dict(_params("ba-ring89"), n_cams=16, n_points=300)
    path = str(tmp_path_factory.mktemp("ring89") / "ba.g2o")
    ba_large.generate(params, 3_000_000_019).write(path)
    return path


def test_a_layout_past_the_padding_bound_routes_flat(ring89_small, monkeypatch):
    """Where the padding bound refuses the uniform layout, as the published
    Venice-89 would, the solver runs neither K1 nor K2's branch."""
    monkeypatch.setattr(assembler, "uniform_padding_fits", lambda E, E_padded: False)
    lm = LevenbergMarquardtSolver(parse_g2o(ring89_small), device="cpu")
    assert lm.asm.pl_uniform is None and not lm.asm.k1
    assert lm._schur.route == "flat" and not lm._schur.uniform


@pytest.mark.parametrize("route", ["uniform", "flat", "sparse"])
def test_branch_spans_and_counters(ring89_small, route, monkeypatch):
    """With the tracer on, each solve counts its route once; the uniform
    branch alone times K2 in ``schur.panels`` (inside ``schur.w_rhs``) and
    counts the panels' bytes.  With it off, nothing is recorded, and the
    result is bitwise the same."""
    if route == "flat":
        monkeypatch.setattr(schur, "UNIFORM_PANEL_BYTES", 0)

    def solve():
        lm = LevenbergMarquardtSolver(parse_g2o(ring89_small), device="cpu")
        if route == "sparse":
            lm._schur = SchurSolver(lm.asm, sparse_reduced_limit=1)
        assert lm._schur.route == route and lm._schur.uniform == (route == "uniform")
        return lm, lm.optimize(3, 0.01)

    lm0, out0 = solve()
    off = timer.drain()
    assert off["spans"] == [] and off["counts"] == []
    timer.enable()
    lm, out = solve()
    rec = timer.drain()
    timer.disable()
    assert out == out0 and lm.trial_log == lm0.trial_log
    spans, counts = rec["spans"], rec["counts"]
    by_id = {s.id: s for s in spans}
    solves = [s for s in spans if s.name == "schur.solve"]
    assert len(solves) == len(lm.trial_log) >= 2
    routes = [c for c in counts if c.name.startswith("schur.route.")]
    assert [c.name for c in routes] == [f"schur.route.{route}"] * len(solves)
    assert sorted(c.span for c in routes) == sorted(s.id for s in solves)
    panels = [s for s in spans if s.name == "schur.panels"]
    nbytes = [c for c in counts if c.name == "schur.panel_bytes"]
    if route != "uniform":
        assert not panels and not nbytes
        return
    assert len(panels) == len(solves)
    assert all(by_id[s.parent].name == "schur.w_rhs" for s in panels)
    asm = lm.asm
    want = 2 * asm.Nl * BL * asm.Np * BP * torch.empty((), dtype=asm.dtype).element_size()
    assert [c.n for c in nbytes] == [want] * len(solves)


def test_k2_work_counts_real_observations(tmp_path):
    """The least work of K2's stage is of real observations: the padded
    slots of an uneven scene's uniform layout and the dense panels' zeros
    count nothing.  The reader returns nothing without a K2 launch."""
    from slam_plus_plus_tpu_torch.io import datasets
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast

    cams, points, obs = datasets.make_ba_scene(n_cams=8, n_points=120, seed=3)
    path = str(tmp_path / "ba.g2o")
    datasets.write_g2o_ba(path, cams, points, obs)
    d = drivers.build(parse_g2o_fast(path), SimpleNamespace(n_obs=len(obs)),
                      {"dtype": "float32"}, {"driver": "batch", "solver": "lm",
                                             "iterations": 1, "dx_threshold": 0.01}, "cpu")
    asm = d.solver.asm
    slots = asm.Nl * asm.M
    assert d.solver._schur.uniform and slots > len(obs)
    n_obs = d.counts()["observations"]
    assert n_obs == len(obs)
    assert panel_work(n_obs, 4) == (n_obs * (54 * 4 + 4), n_obs * 108)
    assert panel_work(n_obs, 4)[0] < panel_work(slots, 4)[0]
    # at ba-ring89's counts: 122 MB against the panels' 1.42 GB
    Np, Nl, n = _shape("ba-ring89")
    nbytes, flops = panel_work(n, 4)
    assert nbytes < 0.1 * 2 * Nl * BL * Np * BP * 4
    least, bound = roofline.least_seconds(nbytes, flops, 4)
    assert bound == "bytes" and least == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)

    read = Spec().reader("k2_roofline_pct")

    def ctx(n_launch, seconds):
        trace = SimpleNamespace(kernels=lambda pattern: (
            (n_launch, seconds) if pattern == "panel_kernel" else (0, 0.0)))
        return SimpleNamespace(trace=trace, counts={"observations": n}, itemsize=4)

    assert read(ctx(0, 0.0)) is None
    assert read(ctx(5, 5 * 2 * least)) == pytest.approx(50.0)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

#: a seed of the benchmark cell ring89.batch (its cameras for each point)
CELL_SEED = 2_718_281_829


@pytest.mark.card
def test_k2_full_shape_is_bitwise_its_plain_version():
    """On the card, float32, at ba-ring89's full shape (110,973 landmarks,
    5 slots, 89 cameras; the cell's camera ids, the solver's transposed
    strided view of the H_pl blocks): K2's panels equal the plain
    version's bit for bit, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = _params("ba-ring89")
    Np, Nl, M = params["n_cams"], params["n_points"], params["obs_per_point"]
    scene = ba_large.generate(params, CELL_SEED)
    assert np.array_equal(scene.obs_point, np.repeat(np.arange(Nl), M))
    dev = torch.device("cuda", 0)
    rows = torch.as_tensor(scene.obs_cam.reshape(Nl, M).astype(np.int32), device=dev)
    g = torch.Generator(device=dev).manual_seed(CELL_SEED)
    pl = torch.randn((Nl * M, BP * BL), generator=g, device=dev)
    u4 = pl.reshape(Nl, M, BP, BL).transpose(2, 3)
    a = torch.randn((Nl, BL, BL), generator=g, device=dev)
    ll = (a @ a.mT + 0.5 * torch.eye(BL, device=dev)).reshape(Nl, BL * BL)
    cinv = planar.binv(ll, BL)
    tiling = panel.panel_tiling(Nl, M, BL, BP, Np, 4)
    launches = panel.build_panels.launches
    Ut, Wt = panel.build_panels(u4, rows, cinv, BL, BP, Np)
    torch.cuda.synchronize()
    assert panel.build_panels.launches == launches + 1
    Ut_p, Wt_p = panel.build_panels_plain(u4, rows, cinv, BL, BP, Np)
    assert Ut.shape == Ut_p.shape == (Nl * BL, Np * BP)
    print(f"tiling (TL, Wcams) {tiling}; panels {Ut.nbytes + Wt.nbytes} bytes")
    assert torch.equal(Ut, Ut_p)
    assert torch.equal(Wt, Wt_p)
