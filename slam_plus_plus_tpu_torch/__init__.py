"""slam_plus_plus_tpu_torch — the PyTorch / CUDA port of slam_plus_plus_tpu.

The port mirrors the JAX package's module paths, so each counterpart sits at
the same relative path.  It imports torch, numpy and scipy, never JAX: the
JAX package stays in the repository as the reference the port's tests hold
it against.

Ported so far: the bundle-adjustment Levenberg-Marquardt main path (g2o BA
input, the uniform per-landmark assembly, the dense Schur solve, the LM
loop), with the two Pallas kernels of that path rewritten as CUDA C++ for
Hopper (``csrc/``).  ROADMAP.md lists what is still to be ported.

Public API:
    parse_g2o / peek_dataset  — BA dataset ingestion (g2o dialect)
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
