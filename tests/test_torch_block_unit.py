"""The port's BlockMatrix (linalg/block_matrix.py) against the JAX package's
on the cases of tests/test_block_matrix.py, exactly (the same numpy
arithmetic in the same order); from_partitioned on a small BA scene against
the JAX package's at 1e-9 x scale (two assemblies); the -rmut suite
(which reaches the block matrix) and the -rmb sheet on the CPU; and the -v
memory line.
"""

import numpy as np
import pytest

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler as JAssembler
from slam_plus_plus_tpu.io.parser import parse_g2o as jparse
from slam_plus_plus_tpu.linalg.block_matrix import BlockMatrix as JBlockMatrix
from slam_plus_plus_tpu.linalg.block_matrix import from_partitioned as jfrom_partitioned
from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.app.block_unit import run_benchmarks, run_unit_tests
from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
from slam_plus_plus_tpu_torch.io import datasets as D
from slam_plus_plus_tpu_torch.io.parser import parse_g2o
from slam_plus_plus_tpu_torch.linalg.block_matrix import BlockMatrix, from_partitioned
from slam_plus_plus_tpu_torch.utils.memusage import device_memory, format_report


def _random_pair(seed, row_sizes, col_sizes, density=0.6):
    """The same random block matrix in both packages."""
    rng = np.random.default_rng(seed)
    t, j = BlockMatrix(row_sizes, col_sizes), JBlockMatrix(row_sizes, col_sizes)
    for i in range(len(row_sizes)):
        for k in range(len(col_sizes)):
            if rng.random() < density:
                blk = rng.standard_normal((row_sizes[i], col_sizes[k]))
                t.set_block(i, k, blk)
                j.set_block(i, k, blk)
    return t, j


def _eq(a, b):
    assert np.array_equal(a, b)


def _case(name, tmp_path):
    if name == "dense_round_trip":
        t, j = _random_pair(0, [3, 2, 4], [2, 3], 1.0)
        d = t.to_dense()
        _eq(d, j.to_dense())
        _eq(BlockMatrix.from_dense(d, [3, 2, 4], [2, 3]).to_dense(),
            JBlockMatrix.from_dense(d, [3, 2, 4], [2, 3]).to_dense())
        _eq(t.to_csr().toarray(), j.to_csr().toarray())
    elif name == "transpose_slice_permute":
        t, j = _random_pair(1, [2, 3, 2], [2, 3, 2])
        _eq(t.transpose().to_dense(), j.transpose().to_dense())
        _eq(t.slice((1, 3), (0, 2)).to_dense(), j.slice((1, 3), (0, 2)).to_dense())
        _eq(t.permute([2, 0, 1], [2, 0, 1]).to_dense(), j.permute([2, 0, 1], [2, 0, 1]).to_dense())
    elif name == "matmul_add":
        (ta, ja), (tb, jb), (tc, jc) = (_random_pair(2, [2, 3], [3, 2]),
                                        _random_pair(3, [3, 2], [2, 2]),
                                        _random_pair(4, [2, 3], [3, 2]))
        _eq(ta.matmul(tb).to_dense(), ja.matmul(jb).to_dense())
        _eq(ta.add(tc).to_dense(), ja.add(jc).to_dense())
    elif name == "block_lu":
        t, j = _random_pair(3, [2, 3, 2], [2, 3, 2], 0.8)
        for i, n in enumerate([2, 3, 2]):
            t.add_to_block(i, i, 3.0 * np.eye(n))
            j.add_to_block(i, i, 3.0 * np.eye(n))
        (tp, tL, tU), (jp, jL, jU) = t.lu(), j.lu()
        assert tp == jp
        _eq(tL.to_dense(), jL.to_dense())
        _eq(tU.to_dense(), jU.to_dense())
    elif name == "matrix_market":
        t, j = _random_pair(4, [2, 3], [2, 3], 0.7)
        t.save_matrix_market(str(tmp_path / "t.mtx"))
        j.save_matrix_market(str(tmp_path / "j.mtx"))
        assert (tmp_path / "t.mtx").read_text() == (tmp_path / "j.mtx").read_text()
        back = BlockMatrix.load_matrix_market(str(tmp_path / "j.mtx"))
        assert back.row_sizes == [2, 3] and back.col_sizes == [2, 3]
        _eq(back.to_dense(), t.to_dense())
    elif name == "vbr":
        t, j = _random_pair(5, [2, 3], [3, 2], 1.0)
        for a, b in zip(t.to_vbr(), j.to_vbr()):
            _eq(a, b)
    elif name == "rasterize_diff":
        (ta, ja), (tb, jb) = _random_pair(6, [2, 2], [2, 2], 1.0), _random_pair(7, [2, 2], [2, 2])
        tb.set_block(0, 0, ta.blocks[(0, 0)])
        jb.set_block(0, 0, ja.blocks[(0, 0)])
        _eq(tb.rasterize_diff(ta), jb.rasterize_diff(ja))
        _eq(ta.occupancy(), ja.occupancy())


@pytest.mark.parametrize("name", ["dense_round_trip", "transpose_slice_permute", "matmul_add",
                                  "block_lu", "matrix_market", "vbr", "rasterize_diff"])
def test_block_matrix_matches_jax(name, tmp_path):
    _case(name, tmp_path)


def test_from_partitioned_matches_jax(tmp_path):
    p = str(tmp_path / "ba.g2o")
    D.write_g2o_ba(p, *D.make_ba_scene(n_cams=4, n_points=30, seed=3))
    ts, js = parse_g2o(p), jparse(p)
    tasm, jasm = Assembler(ts, device="cpu"), JAssembler(js)
    got = from_partitioned(tasm, tasm.assemble(tasm.snapshot_states(ts))).to_dense()
    want = jfrom_partitioned(jasm, jasm.assemble(jasm.snapshot_states(js))).to_dense()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_unit_tests_pass_on_the_cpu():
    assert run_unit_tests(device="cpu", verbose=False)


def _lambda_without_pl(asm, bs):
    m = from_partitioned(asm, bs)
    for k in [k for k in m.blocks if (k[0] < asm.Np) != (k[1] < asm.Np)]:
        del m.blocks[k]
    return m


@pytest.mark.parametrize("name, broken", [
    ("from_partitioned", _lambda_without_pl),
    ("BlockMatrix.transpose", lambda self: self),
], ids=["from_partitioned_drops_pl", "transpose_is_identity"])
def test_unit_tests_catch_a_broken_block_matrix(name, broken, monkeypatch):
    """-rmut reaches the block matrix: a wrong lambda conversion or a
    wrong transpose fails the suite."""
    from slam_plus_plus_tpu_torch.linalg import block_matrix
    owner, _, attr = name.rpartition(".")
    monkeypatch.setattr(getattr(block_matrix, owner) if owner else block_matrix, attr, broken)
    assert not run_unit_tests(device="cpu", verbose=False)


@pytest.mark.parametrize("argv, rc", [
    (["-rmut"], 0),
    (["-rmb", "synthetic", "alloc"], 0),
    (["-rmb", "synthetic", "no-such-type"], 1),
], ids=["rmut", "rmb_alloc", "rmb_bad_type"])
def test_cli_matrix_flags_return_before_any_parse(argv, rc, capsys):
    assert tmain.main(argv + ["--device", "cpu", "-s"]) == rc


def test_benchmark_sheet():
    sheet = run_benchmarks("synthetic", "alloc", device="cpu", verbose=False)
    assert len(sheet) == 3
    assert all(set(row) == {"symbolic_s"} for row in sheet.values())


def test_memory_line(tmp_path, capsys):
    assert device_memory("cpu") == {}
    line = format_report("cpu")
    assert line.startswith("memory: host rss ") and line.endswith(" MB)")
    p = str(tmp_path / "m.g2o")
    poses, edges = D.make_manhattan_2d(n_poses=40, seed=9)
    D.write_g2o_2d(p, edges, poses)
    assert tmain.main(["-i", p, "-v", "--device", "cpu", "-dx", ""]) == 0
    out = capsys.readouterr().out.splitlines()
    i = out.index(next(ln for ln in out if ln.startswith("denormalized chi2 error:")))
    assert out[i + 1].startswith("memory: host rss ")
