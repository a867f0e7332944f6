"""Configuration: dtype and device policy, and the solver settings.

The reference is double precision everywhere.  Policy:

  * on ``cpu`` (tests, verification): float64 everywhere;
  * on ``cuda``, the batch solvers on the Schur route (BA, Sim(3) BA) and
    SPCG: float32, as the JAX package on its accelerator
    (``default_dtype``);
  * on ``cuda``, GN / LM (and the A solver) on the pose-graph route
    (solvers/gauss_newton.py::route_dtype), the incremental engine (FastL
    and the incremental lambda solver), marginal covariances (the CLI's
    -dm, FastL's in-loop marginals) and the Lambda-DL dogleg: float64
    (``float64_dtype``).  Float32 pose GN missed manhattan3500's golden
    on the card (1.13 x); float64 meets every pose golden.
    The card runs float64 natively; float32 misses the trees10k-incr
    golden (the JAX package's own float32 engine does too), float64 hits
    every incremental golden and is no slower on the launch-bound engine,
    and a covariance recovered through the float32 bottom factor would
    inherit its ridge (PERF.md section 5, ROADMAP.md Queue 3).  The
    dogleg's undamped GN step is solved as it stands (a 1e-9 jitter at
    most), and on BA the reduced camera system it solves reaches kappa
    3.4e8, past float32's 1/eps: the float32 dogleg stalls on mono BA and
    is a draw on a small stereo file, in the JAX package too.

Every solver that builds an Assembler takes ``dtype=`` (the JAX package's
``SolverConfig.dtype`` override); None takes the policy above.

The device is always explicit: every entry point takes a ``device`` and
there is no fallback from one device to another.  Nothing here sets a global
default dtype, because tests share worker processes.

Of the JAX package's SolverConfig the port carries, in ``SolverSettings``,
the fields that a caller of the port sets to a second value: the linear
backend, the landmark split, the edge layout, LM's initial damping
(``damping_init``) and the per-edge-type robust losses
(``robust_overrides``).  The JAX package's MarginalsPolicy becomes FastL's
``marginals`` flag: no caller sets its refresh interval or its update
switch to a second value, and its ``part`` is read nowhere.  The float32
PCG keeps the JAX package's 12 trips as a constant until a caller needs
another value; ``dogleg_radius`` is read nowhere in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

LINEAR_SOLVERS = ("auto", "block_cholesky", "scipy")


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """linear_solver, as the JAX package's GaussNewtonSolver reads it:
    "auto" picks Schur when a landmark class is split off, the dense direct
    factor for small float64 systems, else the MIS-Schur block Cholesky;
    "block_cholesky" takes the block Cholesky in place of the dense factor;
    "scipy" forces the host splu oracle (linalg/host_solver.py).

    schur_split: "auto" splits the landmark class off when the pose dims
    stay <= 20000; "on" always, "off" never.  edge_layout: "auto" lets a
    mono BA problem take K1's uniform layout, "uniform" sorts and pads every
    edge type that observes one landmark into per-landmark groups (the
    landmark-sharded BA's layout), "flat" keeps parse order.

    damping_init: LM's initial damping; 0 derives it from the diagonal
    (1e-3 x the largest per-edge vertex-Hessian diagonal, the reference's).
    robust_overrides: {edge type name: (loss, scale)}, with loss a name of
    robust.losses.LOSSES, replaces that robust edge type's registered loss
    and scale; a "*" entry applies to every robust edge type without its
    own entry (reference: the robust mixins' template parameters,
    include/slam/RobustUtils.h:368-502).  A type that is not robust stays
    plain, and the A solver weighs no edge."""

    linear_solver: str = "auto"
    schur_split: str = "auto"
    edge_layout: str = "auto"
    damping_init: float = 0.0
    robust_overrides: Optional[dict] = None

    def __post_init__(self):
        if self.linear_solver not in LINEAR_SOLVERS:
            raise ValueError(f"linear_solver {self.linear_solver!r}: one of "
                             f"{', '.join(LINEAR_SOLVERS)}")
        if self.schur_split not in ("auto", "on", "off"):
            raise ValueError(f"schur_split {self.schur_split!r}: auto, on or off")
        if self.edge_layout not in ("auto", "uniform", "flat"):
            raise ValueError(f"edge_layout {self.edge_layout!r}: auto, uniform or flat")
        from slam_plus_plus_tpu_torch.robust.losses import LOSSES
        for name, (loss, _scale) in (self.robust_overrides or {}).items():
            if loss not in LOSSES:
                raise ValueError(f"robust_overrides[{name!r}]: loss {loss!r} is not one of "
                                 f"{', '.join(LOSSES)}")


def default_dtype(device) -> torch.dtype:
    """float64 on cpu, float32 on cuda."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.float64
    if dev.type == "cuda":
        return torch.float32
    raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")


def float64_dtype(device) -> torch.dtype:
    """float64 on both devices: pose-graph GN / LM, the incremental engine,
    marginals and the Lambda-DL dogleg."""
    default_dtype(device)   # rejects an unsupported device
    return torch.float64


def pin_precision() -> None:
    """Keep float32 matrix products in full float32 on the card.

    TF32 keeps about three decimal digits; reduced-precision matmul passes
    corrupted the assembled normal matrix in the JAX package
    (docs/BENCH_NOTES.md, round 4), and TF32 is the same hazard.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
