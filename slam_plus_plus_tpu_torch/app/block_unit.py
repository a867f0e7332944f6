"""Built-in block-matrix unit tests (-rmut) and benchmarks (-rmb).

Port of slam_plus_plus_tpu/app/block_unit.py (reference
CBlockMatrixUnitTests::RunAll behind -rmut, include/slam_app/BlockUnit.h:59-120,
and CBlockMatrixBenchmark behind -rmb, include/slam_app/BlockBench.h:122,2224):
addition, the planar block products and inverses of ops/planar.py, and the
MIS-Schur block Cholesky (linalg/block_cholesky.py) against a dense oracle
on random SPD block patterns, all on the device the caller names; then the
general block matrix (linalg/block_matrix.py): its algebra against dense
numpy, and the assembler's lambda, assembled on that device, against AᵀA
of the A solver's Jacobian.  The
benchmark sheet times the symbolic plan and factor + solve on synthetic
block systems at three scales (the reference's UF-collection matrices are
not in the repository).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from slam_plus_plus_tpu_torch.config import default_dtype


def _random_spd_pattern(rng, n, extra_pairs, B):
    """A random connected SPD block pattern: upper pairs and planar blocks
    (numpy)."""
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    if n > 1:
        rows.append(np.arange(n - 1))
        cols.append(np.arange(1, n))
    for _ in range(extra_pairs):
        a, b = rng.integers(0, n, 2)
        if a == b:
            continue
        rows.append(np.array([min(a, b)]))
        cols.append(np.array([max(a, b)]))
    keys = np.unique(np.concatenate(rows) * n + np.concatenate(cols))
    rows, cols = keys // n, keys % n

    K = len(rows)
    blocks = rng.normal(size=(K, B, B))
    diag = rows == cols
    # SPD: symmetric diagonal blocks and diagonal dominance
    blocks[diag] = blocks[diag] + np.transpose(blocks[diag], (0, 2, 1))
    deg = np.bincount(rows, minlength=n) + np.bincount(cols, minlength=n)
    for i in np.flatnonzero(diag):
        blocks[i] += np.eye(B) * (B * (deg[rows[i]] + 2))
    return rows, cols, blocks.reshape(K, B * B)


def _dense_of(rows, cols, blocks, n, B):
    A = np.zeros((n * B, n * B))
    for k in range(len(rows)):
        r, c = rows[k], cols[k]
        A[r * B:(r + 1) * B, c * B:(c + 1) * B] += blocks[k].reshape(B, B)
        if r != c:
            A[c * B:(c + 1) * B, r * B:(r + 1) * B] += blocks[k].reshape(B, B).T
    return A


def run_unit_tests(*, device, verbose: bool = True) -> bool:
    """The -rmut suite, float64 on ``device``.  True when every check
    passes."""
    from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver
    from slam_plus_plus_tpu_torch.linalg.block_matrix import BlockMatrix, from_partitioned
    from slam_plus_plus_tpu_torch.ops import planar

    rng = np.random.default_rng(7)
    ok = True

    def dev(x):
        return torch.as_tensor(x, device=device)

    def host(t):
        return t.cpu().numpy()

    def check(name, cond):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'PASS' if cond else 'FAIL'}] {name}")

    # addition (MatrixAddition_UnitTest)
    for B in (2, 3, 6):
        a = rng.normal(size=(64, B * B))
        b = rng.normal(size=(64, B * B))
        check(f"addition B={B}", np.allclose(host(dev(a) + dev(b)), a + b))

    # the planar block products (MatrixMultiplication_UnitTest)
    for (Br, Bm, Bc) in ((3, 3, 3), (6, 3, 6), (2, 2, 2), (6, 6, 6)):
        K = 128
        a = rng.normal(size=(K, Br * Bm))
        b = rng.normal(size=(K, Bm * Bc))
        want = np.einsum("kij,kjl->kil", a.reshape(K, Br, Bm),
                         b.reshape(K, Bm, Bc)).reshape(K, Br * Bc)
        check(f"bmm {Br}x{Bm}x{Bc}",
              np.allclose(host(planar.bmm(dev(a), dev(b), Br, Bm, Bc)), want, atol=1e-10))
        want = np.einsum("kij,klj->kil", a.reshape(K, Br, Bm),
                         a.reshape(K, Br, Bm)).reshape(K, Br * Br)
        check(f"bmm_A_Bt {Br}x{Bm}",
              np.allclose(host(planar.bmm_A_Bt(dev(a), dev(a), Br, Bm, Br)), want, atol=1e-10))

    for B in (2, 3, 6):
        m = rng.normal(size=(64, B, B))
        spd = np.einsum("kij,klj->kil", m, m) + 3 * np.eye(B)
        want = np.linalg.inv(spd).reshape(64, B * B)
        check(f"binv B={B}",
              np.allclose(host(planar.binv(dev(spd.reshape(64, B * B)), B)), want, atol=1e-8))

    # decomposition (MatrixDecomposition_UnitTest): the MIS-Schur block
    # Cholesky against a dense solve
    for (n, extra, B) in ((40, 60, 3), (120, 200, 3), (60, 100, 6)):
        rows, cols, blocks = _random_spd_pattern(rng, n, extra, B)
        A = _dense_of(rows, cols, blocks, n, B)
        eta = rng.normal(size=(n, B))
        solver = BlockCholeskySolver(rows, cols, n, B, device=device, bottom=8)
        dx = host(solver.solve(dev(blocks), dev(eta)))
        want = np.linalg.solve(A, eta.reshape(-1)).reshape(n, B)
        rel = np.abs(dx - want).max() / (np.abs(want).max() + 1e-30)
        check(f"block cholesky solve n={n} B={B} (rel {rel:.2e})", rel < 1e-8)

    # the general block matrix (the reference's CUberBlockMatrix tests):
    # its algebra against dense numpy on a random SPD pattern
    n, B = 12, 3
    rows, cols, blocks = _random_spd_pattern(rng, n, 20, B)
    A = _dense_of(rows, cols, blocks, n, B)
    m = BlockMatrix([B] * n, [B] * n)
    for r, c, blk in zip(rows, cols, blocks.reshape(-1, B, B)):
        m.add_to_block(r, c, blk)
        if r != c:
            m.add_to_block(c, r, blk.T)
    check("block matrix to_dense / to_csr",
          np.array_equal(m.to_dense(), A) and np.array_equal(m.to_csr().toarray(), A))
    # a slice off the diagonal is not symmetric: it checks the transpose
    part, dense_part = m.slice((2, 7), (4, 9)), A[2 * B:7 * B, 4 * B:9 * B]
    perm = rng.permutation(n)
    sub = np.concatenate([np.arange(b * B, (b + 1) * B) for b in perm])
    check("block matrix slice / permute / transpose",
          np.array_equal(part.to_dense(), dense_part) and
          np.array_equal(m.permute(perm, perm).to_dense(), A[np.ix_(sub, sub)]) and
          np.array_equal(part.transpose().to_dense(), dense_part.T))
    check("block matrix add / matmul",
          np.array_equal(m.add(m).to_dense(), 2 * A) and
          np.allclose(part.matmul(part.transpose()).to_dense(), dense_part @ dense_part.T,
                      rtol=1e-12, atol=1e-12 * np.abs(A).max() ** 2))
    piv, L, U = m.lu()
    rp = np.concatenate([np.arange(b * B, (b + 1) * B) for b in piv])
    check("block matrix LU", np.allclose(L.to_dense() @ U.to_dense(), A[rp], atol=1e-10 * np.abs(A).max()))

    # the assembler's lambda on the device as a block matrix against AᵀA of
    # the A solver's weighted Jacobian on the host (a small mono BA scene)
    from slam_plus_plus_tpu_torch.app.ba_optimizer import BAOptimizer
    from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
    from slam_plus_plus_tpu_torch.io.datasets import make_ba_scene
    from slam_plus_plus_tpu_torch.solvers.a_solver import ASolver
    opt = BAOptimizer(device="cpu")
    cams, pts, obs = make_ba_scene(n_cams=4, n_points=40, seed=3)
    for c, (pos, q, fx, fy, cx, cy, d) in enumerate(cams):
        opt.add_cam_vertex_g2o(c, pos, q, fx, fy, cx, cy, d)
    for p, pt in enumerate(pts):
        opt.add_xyz_vertex(len(cams) + p, pt + rng.normal(0, 0.05, 3))
    for (pid, cid, u, v) in obs:
        opt.add_p2c_edge(len(cams) + pid, cid, [u, v], np.eye(2))
    asm = Assembler(opt.system, device=device, dtype=torch.float64)
    lam = from_partitioned(asm, asm.assemble(asm.snapshot_states(opt.system))).to_dense()
    Aj, _b = ASolver(opt.system, device="cpu").materialize_A()
    AtA = (Aj.T @ Aj).toarray()
    rel = np.abs(lam - AtA).max() / np.abs(AtA).max()
    check(f"block matrix of the assembled lambda = AᵀA (rel {rel:.2e})", rel < 1e-10)

    if verbose:
        print("block matrix unit tests:", "PASS" if ok else "FAIL")
    return ok


def run_benchmarks(name: str = "synthetic", btype: str = "all", *, device,
                   verbose: bool = True) -> dict:
    """The -rmb sheet: per scale, the symbolic plan's seconds ('alloc') and
    the ms of one factor + solve ('factor'; the mean of 5 after a warm-up,
    ended by a device synchronize on a card), in the device's batch dtype.
    btype: alloc, factor or all (the reference's benchmark type,
    src/slam_app/Main.cpp:103-104)."""
    from slam_plus_plus_tpu_torch.linalg.block_cholesky import BlockCholeskySolver

    if btype not in ("alloc", "factor", "all"):
        raise ValueError(f"benchmark type {btype!r}: alloc, factor or all")
    device = torch.device(device)
    dtype = default_dtype(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(11)
    sheet = {}
    for (n, extra, B) in ((500, 1000, 3), (2000, 4000, 3), (5000, 10000, 6)):
        rows, cols, blocks = _random_spd_pattern(rng, n, extra, B)
        eta = rng.normal(size=(n, B))
        row = {}
        t0 = time.perf_counter()
        solver = BlockCholeskySolver(rows, cols, n, B, device=device, bottom=64)
        if btype in ("alloc", "all"):
            row["symbolic_s"] = round(time.perf_counter() - t0, 4)
        if btype in ("factor", "all"):
            bt = torch.as_tensor(blocks, dtype=dtype, device=device)
            et = torch.as_tensor(eta, dtype=dtype, device=device)
            solver.solve(bt, et)
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                solver.solve(bt, et)
            sync()
            row["factor_solve_ms"] = round((time.perf_counter() - t0) / 5 * 1e3, 3)
        key = f"n={n} B={B} K={len(rows)}"
        sheet[key] = row
        if verbose:
            print(f"  {name}: {key} ({dtype}, {device}): {row}")
    return sheet
