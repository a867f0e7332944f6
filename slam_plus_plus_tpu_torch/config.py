"""Configuration: dtype and device policy.

The reference is double precision everywhere.  Policy, as in the JAX
package (slam_plus_plus_tpu/config.py):

  * on ``cpu`` (tests, verification): float64;
  * on ``cuda``: float32.

The device is always explicit: every entry point takes a ``device`` and
there is no fallback from one device to another.  Nothing here sets a global
default dtype, because tests share worker processes.

Of the JAX package's SolverConfig the port carries the two fields that have
a second value here, in ``SolverSettings``: the linear backend and the
landmark-class split.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """linear_solver: "auto" picks as the JAX package does (Schur when a
    landmark class is split off, dense direct for small float64 systems,
    else the MIS-Schur block Cholesky); "block_cholesky" takes the block
    Cholesky in place of the dense direct factor.  schur_split: "auto"
    splits the landmark class off when the pose dims stay <= 20000; "on"
    always, "off" never."""

    linear_solver: str = "auto"
    schur_split: str = "auto"

    def __post_init__(self):
        if self.linear_solver not in ("auto", "block_cholesky"):
            raise ValueError(f"linear_solver {self.linear_solver!r}: the port has "
                             "auto and block_cholesky (the host scipy oracle is "
                             "ROADMAP.md Queue 1 item 15)")
        if self.schur_split not in ("auto", "on", "off"):
            raise ValueError(f"schur_split {self.schur_split!r}: auto, on or off")


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

