"""Configuration: dtype and device policy.

The reference is double precision everywhere.  Policy, as in the JAX
package (slam_plus_plus_tpu/config.py):

  * on ``cpu`` (tests, verification): float64;
  * on ``cuda``: float32.

The device is always explicit: every entry point takes a ``device`` and
there is no fallback from one device to another.  Nothing here sets a global
default dtype, because tests share worker processes.

The JAX package's SolverConfig selects among solvers, linear backends, class
splits and edge layouts; the port has one of each so far, so it has no
settings object yet.
"""

from __future__ import annotations

import torch


def default_dtype(device) -> torch.dtype:
    """float64 on cpu, float32 on cuda."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.float64
    if dev.type == "cuda":
        return torch.float32
    raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")


def pin_precision() -> None:
    """Keep float32 matrix products in full float32 on the card.

    TF32 keeps about three decimal digits; reduced-precision matmul passes
    corrupted the assembled normal matrix in the JAX package
    (docs/BENCH_NOTES.md, round 4), and TF32 is the same hazard.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

