"""slam_plus_plus_tpu_torch — the PyTorch / CUDA port of slam_plus_plus_tpu.

The port mirrors the JAX package's module paths, so each counterpart sits at
the same relative path.  It imports torch, numpy and scipy, never JAX: the
JAX package stays in the repository as the reference the port's tests hold
it against.

Ported so far: every batch solver — batch bundle adjustment (mono,
intrinsics, stereo and spheron g2o input; the uniform per-landmark and the
generic assembly; the dense and the sparse-reduced Schur solves;
Lambda-LM and the Lambda-DL dogleg), batch pose-graph SLAM (SE(2)/SE(3),
landmarks, GN over the MIS-Schur block Cholesky), the A and SPCG solvers,
the host scipy oracle, and the Sim(3) and ROCV families — with the two
Pallas kernels of the BA path rewritten as CUDA C++ for Hopper
(``csrc/``); the incremental engines, marginal covariances, the native host
code, and the host tools and example apps (geometry, the eigensolver,
nested-Schur analysis, matrix I/O, FLOP counts, the stage timer, poly
fitting and the ACRA study), and distribution over torch.distributed
(``parallel/``).  ROADMAP.md lists the TPU- and XLA-only code that is not
ported.

Public API:
    parse_g2o / peek_dataset  — dataset ingestion (g2o dialect)
    GraphSystem               — typed columnar factor-graph container
    default_dtype / pin_precision
"""

from slam_plus_plus_tpu_torch.config import default_dtype, pin_precision
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.io.parser import parse_g2o, peek_dataset

__version__ = "0.1.0"

__all__ = [
    "default_dtype",
    "pin_precision",
    "GraphSystem",
    "parse_g2o",
    "peek_dataset",
    "__version__",
]
