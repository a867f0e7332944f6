"""The port's fixed-order segmented sums (ops/segsum.py), which replace the
atomic ``index_add_`` on the float64 routes: on the CPU they equal a
sequential ``index_add_`` bit for bit (the same summation order), and two
calls give equal bits.  The solvers built on them keep their parity tests'
tolerances against the JAX package; here, two replays of one file through
FastL and two block Cholesky solves of one lambda are equal bit for bit."""

import numpy as np
import pytest
import torch

from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
from slam_plus_plus_tpu_torch.ops.segsum import (SegmentSum, index_add_ordered, segment_order,
                                                 segment_sum)
from slam_plus_plus_tpu_torch.solvers.fastl import FastLSolver


def _case(T, n, tail, seed):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, T)
    vals = torch.tensor(rng.standard_normal((T,) + tail))
    return dst, vals


@pytest.mark.parametrize("T,n,tail", [(0, 5, (4,)), (7, 5, (9,)), (3000, 200, (3, 3)),
                                      (500, 20000, (36,))])
def test_segment_sum_equals_index_add(T, n, tail):
    """A fixed destination plan (SegmentSum), repeated destinations or
    none, against index_add_ into zeros; two calls equal."""
    dst, vals = _case(T, n, tail, seed=T + n)
    want = torch.zeros((n,) + tail, dtype=torch.float64).index_add_(
        0, torch.as_tensor(dst), vals)
    plan = SegmentSum(dst, n, "cpu")
    got = plan(vals)
    assert torch.equal(got, want)
    assert torch.equal(plan(vals), got)


def test_distinct_destinations_keep_the_scatter():
    dst = np.random.default_rng(0).permutation(50)[:30]
    assert SegmentSum(dst, 50, "cpu").unique
    assert not SegmentSum(np.array([3, 1, 3]), 5, "cpu").unique


def test_segment_order_batches_levels_and_drops_padding():
    """Run-time destinations (the incremental engine's dirty lists): every
    row of a [L, T] batch sorted in one call; a destination n (padding)
    drops."""
    rng = np.random.default_rng(1)
    n, T = 40, 300
    dst = torch.as_tensor(rng.integers(0, n + 1, (4, T)))
    vals = torch.tensor(rng.standard_normal((T, 9)))
    perm, offsets = segment_order(dst, n)
    assert offsets.shape == (4, n + 1)
    for li in range(4):
        keep = dst[li] < n
        want = torch.zeros((n, 9), dtype=torch.float64).index_add_(0, dst[li][keep],
                                                                   vals[keep])
        got = segment_sum(vals, perm[li], offsets[li])
        assert torch.equal(got, want)
        assert torch.equal(segment_sum(vals, perm[li], offsets[li]), got)


@pytest.mark.parametrize("T", [0, 1, 64, 2000])
def test_index_add_ordered_onto_values(T):
    """out[dst] += values onto a tensor that holds values, in source
    order: the bits of index_add_ on the CPU, and of a second call."""
    rng = np.random.default_rng(T)
    n = 100
    base = torch.tensor(rng.standard_normal((n, 6)))
    dst = torch.as_tensor(rng.integers(0, n, T))
    vals = torch.tensor(rng.standard_normal((T, 6)))
    want = base.clone().index_add_(0, dst, vals)
    got = index_add_ordered(base.clone(), dst, vals)
    assert torch.equal(got, want)
    assert torch.equal(index_add_ordered(base.clone(), dst, vals), got)


@pytest.fixture(scope="module")
def manhattan(tmp_path_factory):
    poses, edges = D.make_manhattan_2d(n_poses=400, seed=91, loop_prob=0.3)
    p = str(tmp_path_factory.mktemp("segsum") / "m.g2o")
    D.write_g2o_2d(p, edges, poses)
    return p


def test_block_cholesky_solves_repeat(manhattan):
    """Two factor + solve passes of one float64 lambda, bit for bit."""
    s = parse_g2o(manhattan)
    asm = Assembler(s, device="cpu")
    bs = asm.assemble(asm.snapshot_states(s))
    chol = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp, device="cpu",
                               bottom=32)
    assert chol.n_levels > 2
    assert torch.equal(chol.solve(bs.pp_blocks, bs.eta_p), chol.solve(bs.pp_blocks, bs.eta_p))
    f = chol.factor(bs.pp_blocks)
    assert torch.equal(chol.marginals(f), chol.marginals(chol.factor(bs.pp_blocks)))


def test_fastl_replays_repeat(manhattan):
    """Two -nsp 1 -fL replays of one file: equal chi2, iterations, pushes
    and states, bit for bit."""
    runs = []
    for _ in range(2):
        fl = FastLSolver(parse_g2o(manhattan), device="cpu", every_n=1)
        chi2, iters = fl.run()
        runs.append((chi2, iters, fl.stats["pushes"],
                     fl.system.vertex_stores["pose2d"].data.copy()))
    (c1, i1, p1, x1), (c2, i2, p2, x2) = runs
    assert (c1, i1, p1) == (c2, i2, p2)
    assert np.array_equal(x1, x2)
