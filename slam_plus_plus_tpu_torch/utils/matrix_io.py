"""Matrix I/O and the sparsity raster.

Port of slam_plus_plus_tpu/utils/matrix_io.py (reference CUberBlockMatrix
MatrixMarket / block-layout I/O, include/slam/BlockMatrix.h:3802-3851, and
the sparsity rasterization, :253-335, Rasterize).  The blocks come to the
host with one ``.cpu()`` per block array and go through the port's
``linalg/bsr.py::partitioned_to_scipy`` (``block_system_to_scipy``).
"""

from __future__ import annotations

import numpy as np

from slam_plus_plus_tpu_torch.linalg.bsr import block_system_to_scipy


def save_matrix_market(path, asm, bs):
    """Write the partitioned lambda as a symmetric MatrixMarket file (upper
    storage), matching the reference's Save_MatrixMarket output layout."""
    A = block_system_to_scipy(asm, bs).tocoo()
    mask = A.row <= A.col
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write("% lambda matrix for SLAM problem\n")
        n = A.shape[0]
        f.write(f"{n} {n} {int(mask.sum())}\n")
        for r, c, v in zip(A.row[mask], A.col[mask], A.data[mask]):
            f.write(f"{c + 1} {r + 1} {v:.17g}\n")  # MM is column-major-ish


def save_block_layout(path, asm):
    """Write the block structure (.bla analogue): block sizes + pattern."""
    with open(path, "w") as f:
        f.write(f"Np {asm.Np} Bp {asm.Bp} Nl {asm.Nl} Bl {asm.Bl}\n")
        f.write(f"Kpp {asm.Kpp} Kpl {asm.Kpl}\n")
        for r, c in zip(asm.pp_rows, asm.pp_cols):
            f.write(f"pp {r} {c}\n")
        for r, c in zip(asm.pl_rows, asm.pl_cols):
            f.write(f"pl {r} {c}\n")


def rasterize_sparsity(path, asm):
    """Render the lambda sparsity pattern to a PNG (reference Rasterize);
    None where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    n_blocks = asm.Np + asm.Nl
    img = np.ones((n_blocks, n_blocks))
    for r, c in zip(asm.pp_rows, asm.pp_cols):
        img[r, c] = 0
        img[c, r] = 0
    for r, c in zip(asm.pl_rows, asm.pl_cols):
        img[r, asm.Np + c] = 0.4
        img[asm.Np + c, r] = 0.4
    for l in range(asm.Nl):
        img[asm.Np + l, asm.Np + l] = 0.4
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(img, cmap="gray", interpolation="nearest")
    ax.set_title(f"lambda block sparsity ({n_blocks} blocks)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
