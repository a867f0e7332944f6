"""Powell's dogleg trust-region solver ("Lambda-DL").

Port of slam_plus_plus_tpu/solvers/dogleg.py (reference
CNonlinearSolver_Lambda_DL, include/slam/NonlinearSolver_Lambda_DL.h:242-1560,
the 3DV-2017 BA solver), over the port's GaussNewtonSolver linear backends:

  * trust radius delta starts at 2 (INITIAL_TRUST_RADIUS);
  * alpha (steepest-descent scale) = |eta|^2 / (eta^T lambda eta) (:1239-1242);
  * step (:1290-1330): the GN step if |h_gn| <= delta; the scaled steepest
    descent if alpha |eta| >= delta; else the dogleg point on the segment
    a + beta (b - a) with |.| = delta, beta from the roundoff-compensated
    quadratic;
  * gain = (f0 - f1) / (dx . (2 eta - lambda dx)) (:1505-1510);
  * delta /= max(1/3, 1 - (2 g - 1)^3); a bad step keeps the old state and
    retries with the new radius; stop when delta < threshold (:1516-1543);
  * a non-finite GN step (the gauge-deficient lambda of pure BA) is retried
    once on lambda + 1e-9 max-diag I, and if still non-finite the Cauchy
    point, clipped to delta, is taken (:1157).

Only a non-finite GN step counts as a failed one: an exception from the
linear solve (a kernel failure on the card) propagates.  Fluid
relinearization and the incrementally maintained Schur complement of the
reference are not ported, as in the JAX package: the batch solver
relinearizes fully each iteration.  Host syncs per iteration: about ten
scalar reads (the step norms, dot products and the new chi2).

It runs float64 on both devices (``config.float64_dtype``): its GN step
solves lambda undamped, and in float32 that step is not finite on mono BA
and a draw on an ill-conditioned stereo file (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from slam_plus_plus_tpu_torch.config import SolverSettings, float64_dtype
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.linalg.spmv import LambdaSpmv
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
from slam_plus_plus_tpu_torch.solvers.lm import damp_system


#: initial trust radius (reference :405, the CLI's -dlss default)
INITIAL_TRUST_RADIUS = 2.0


def _dot(ap, al, bp, bl) -> float:
    return float(torch.sum(ap * bp) + torch.sum(al * bl))


class DoglegSolver(GaussNewtonSolver):
    def __init__(self, system: GraphSystem, *, device,
                 settings: Optional[SolverSettings] = None, dtype=None):
        """dtype: the assembler's (None: ``float64_dtype(device)``, float64
        on both devices; ``torch.float32`` gives the JAX package's float32
        dogleg)."""
        super().__init__(system, device=device, settings=settings,
                         dtype=dtype or float64_dtype(device))
        self._lambda_mv = LambdaSpmv(self.asm)

    def _gn_step(self, bs):
        """(dx_p, dx_l, finite): the GN step, retried once with a 1e-9
        max-diag jitter when it is not finite."""
        dx_p, dx_l = self._solve(bs)
        if math.isfinite(float(torch.sum(dx_p) + torch.sum(dx_l))):
            return dx_p, dx_l, True
        jitter = float(bs.max_hdiag) * 1e-9
        dx_p, dx_l = self._solve(damp_system(bs, jitter, self.asm.pp_diag_ids_dev))
        return dx_p, dx_l, math.isfinite(float(torch.sum(dx_p) + torch.sum(dx_l)))

    def optimize(self, max_iterations: int = 5, dx_threshold: float = 0.01,
                 verbose: bool = False):
        """Run the dogleg loop; writes the optimized states back to the
        system.  Returns (final_chi2, iterations_run)."""
        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)
        delta = INITIAL_TRUST_RADIUS

        bs = asm.assemble(states)
        last_error = float(bs.chi2)
        n_iters = 0
        for it in range(max_iterations):
            n_iters += 1
            eta_p, eta_l = bs.eta_p, bs.eta_l
            gn_p, gn_l, gn_ok = self._gn_step(bs)
            gn_norm = (math.sqrt(_dot(gn_p, gn_l, gn_p, gn_l)) if gn_ok else math.inf)
            if gn_ok and gn_norm <= dx_threshold:
                break  # reference: GN step below threshold (:1394)

            eta_norm = math.sqrt(_dot(eta_p, eta_l, eta_p, eta_l))
            if eta_norm < 1e-14:
                break
            lam_eta_p, lam_eta_l = self._lambda_mv(bs, eta_p, eta_l)
            denom = _dot(eta_p, eta_l, lam_eta_p, lam_eta_l)
            alpha = eta_norm ** 2 / denom if denom > 0 else 0.0

            # step selection (reference :1290-1330)
            if gn_ok and gn_norm <= delta:
                dl_p, dl_l, dl_norm = gn_p, gn_l, gn_norm
            elif (not gn_ok) or alpha * eta_norm >= delta:
                scale = delta / eta_norm
                if not gn_ok:
                    scale = min(alpha, scale)  # Cauchy point, clipped (:1354-1359)
                dl_p, dl_l, dl_norm = eta_p * scale, eta_l * scale, eta_norm * scale
            else:
                a_p, a_l = eta_p * alpha, eta_l * alpha
                b_p, b_l = gn_p - a_p, gn_l - a_l
                bb = _dot(b_p, b_l, b_p, b_l)
                c = _dot(a_p, a_l, b_p, b_l)
                a2 = (alpha * eta_norm) ** 2
                disc = math.sqrt(c * c + bb * (delta * delta - a2))
                beta = ((-c + disc) / bb if c <= 0 else (delta * delta - a2) / (c + disc))
                dl_p, dl_l = a_p + beta * b_p, a_l + beta * b_l
                dl_norm = math.sqrt(_dot(dl_p, dl_l, dl_p, dl_l))

            new_states = asm.update(states, dl_p, dl_l)
            new_bs = asm.assemble(new_states)
            error = float(new_bs.chi2)

            # gain = (f0 - f1) / (dx . (2 eta - lambda dx))   (:1505-1510)
            lam_dx_p, lam_dx_l = self._lambda_mv(bs, dl_p, dl_l)
            pred = _dot(dl_p, dl_l, 2.0 * eta_p - lam_dx_p, 2.0 * eta_l - lam_dx_l)
            gain = (last_error - error) / pred if pred != 0 else -1.0
            if verbose:
                print(f"iter {it}: chi2: {error:f} |dl|={dl_norm:.6f} "
                      f"delta={delta:.4g} gain={gain:.3f}")

            delta = delta / max(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
            if gain > 0:
                states, bs, last_error = new_states, new_bs, error
            # a bad step keeps the old state and retries with the new radius
            if delta < dx_threshold:
                break

        chi2 = float(asm.chi2(states))
        asm.writeback_states(self.system, states)
        self.timing["optimize"] = time.perf_counter() - t0
        return chi2, n_iters
