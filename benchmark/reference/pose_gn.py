"""Plain reference of a batch Gauss-Newton solve of a 2D pose graph
(SLAM++'s CNonlinearSolver_Lambda::Optimize, NonlinearSolver_Lambda.h, run
as the CLI's ``-po``).

The initial estimate is the one a reader of the file builds: edges in file
order, a vertex placed when an edge first names it, the first edge's first
vertex at the origin and any other at its edge's other end composed with
the measurement.  The gauge is a unary anchor: the identity added to the
diagonal block of the first edge's first vertex, at every linearization.
Each of up to ``iterations`` iterations forms Lambda and eta densely over
every edge and vertex ([3n, 3n]) at the current states, solves by a dense
Cholesky, and stops before pushing when |dx| is not finite or at most
``dx_threshold``; otherwise it pushes x + dx, the heading wrapped.  The
answer is the states after the last push and their chi2.

The residuals, the placement, the step and the numbers compared are
``pose_fastl``'s; every matrix product goes through ``Precision.mm``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.pose_fastl import _Graph, as_answer, compare  # noqa: F401
from benchmark.reference.precision import Precision


def solve(scene, traffic: dict, P: Precision, device) -> dict:
    """The reference answer for the scene (as read) under traffic's
    ``iterations`` and ``dx_threshold``: poses [N, 3] in vertex-id order,
    chi2, and the iterations run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = _Graph(scene, P, device)
    seen = set()
    for k in range(len(g.a)):
        for slot, v in enumerate((int(g.a[k]), int(g.b[k]))):
            if v not in seen:
                seen.add(v)
                g.place(k, slot)
    m, n = len(g.a), len(g.ids)
    iterations = 0
    for _ in range(int(traffic["iterations"])):
        iterations += 1
        dx = g.step(m, n)
        norm = float(torch.linalg.vector_norm(dx))
        if not math.isfinite(norm) or norm <= float(traffic["dx_threshold"]):
            break
        g.push(dx, n)
    poses = np.zeros((int(g.ids.max()) + 1, 3))
    poses[g.ids] = g.x.detach().to("cpu", torch.float64).numpy()
    return dict(poses=poses, chi2=g.chi2(g.x, m), iterations=iterations)
