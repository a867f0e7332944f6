"""Minimal curve-fitting intro — the poly_fitting_example analogue.

Port of slam_plus_plus_tpu/app/poly_fitting.py (reference
src/poly_fitting_example: the tutorial showing how a user defines their
own vertex and edge types and runs the NLS machinery on a non-SLAM
problem).  A polynomial-coefficient vertex and a sample edge go into the
same type registry the SLAM models use; the port's registry takes batched
residuals (``[..., dim]``), so the residual is written over a batch of
samples.  The Gauss-Newton solver does the rest, in float64 on either
device (a tutorial whose answer is compared with the CPU's).

    python -m slam_plus_plus_tpu_torch.app.poly_fitting [degree] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.models.types import EDGE_TYPES, edge_type, vertex_type
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver

DEGREE = 4  # quartic, like the reference example


def _register(degree: int = DEGREE):
    """User-defined types: one vertex holding the coefficients, one unary
    edge per sample (z = [x, y], residual = y - p(x))."""
    name_v, name_e = f"poly{degree}", f"poly{degree}_sample"
    if name_e in EDGE_TYPES:
        return name_v, name_e
    vertex_type(name_v, degree + 1, degree + 1, lambda c, dc: c + dc,
                schur_class="pose")

    def residual(states, z):
        (coeffs,) = states
        x, y = z[..., 0], z[..., 1]
        powers = x[..., None] ** torch.arange(coeffs.shape[-1], dtype=z.dtype,
                                              device=z.device)
        return (y - (coeffs * powers).sum(-1))[..., None]

    edge_type(name_e, (name_v,), 1, 2, residual)
    return name_v, name_e


def fit(xs, ys, degree: int = DEGREE, *, device="cuda"):
    """Fit y ~ poly(x) on ``device``, unit information per sample (the JAX
    default sigma of 1); returns (coefficients, final chi2)."""
    name_v, name_e = _register(degree)
    sys_ = GraphSystem()
    sys_.add_vertex(0, name_v, np.zeros(degree + 1))
    info = np.array([[1.0]])
    for x, y in zip(xs, ys):
        sys_.add_edge(name_e, (0,), np.array([x, y]), info)
    gn = GaussNewtonSolver(sys_, device=device, dtype=torch.float64)
    chi2, _ = gn.optimize(10)
    return np.asarray(sys_.vertex_stores[name_v].data[0]), chi2


def demo_data(degree: int = DEGREE):
    """The example's samples: random true coefficients (seed 0), 200 points
    on [-1, 1] with N(0, 0.05) noise.  Returns (true coeffs, xs, ys)."""
    rng = np.random.default_rng(0)
    true_c = rng.normal(0, 1, degree + 1)
    xs = np.linspace(-1, 1, 200)
    ys = np.polyval(true_c[::-1], xs) + rng.normal(0, 0.05, xs.shape)
    return true_c, xs, ys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="poly_fitting")
    p.add_argument("degree", nargs="?", type=int, default=DEGREE)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch sees no CUDA device; "
              "run on a GPU or pass --device cpu", file=sys.stderr)
        return 2
    true_c, xs, ys = demo_data(args.degree)
    c, chi2 = fit(xs, ys, degree=args.degree, device=args.device)
    print("true coeffs:", np.round(true_c, 4))
    print("fit  coeffs:", np.round(c, 4))
    print(f"final chi2: {chi2:.3f} over {len(xs)} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
