"""Levenberg-Marquardt ("Lambda-LM") solver — the reference default for BA.

Port of slam_plus_plus_tpu/solvers/lm.py (reference
CNonlinearSolver_Lambda_LM, include/slam/NonlinearSolver_Lambda_LM.h:97-226,
796-1140), with the same semantics:

    alpha = 1e-3 * max per-edge vertex-Hessian diagonal; nu = 2; fail = 10
    last_error = chi2(x)
    for iteration < max_iters:                 # max_iters grows on failures
        lambda  <- refresh at linpoint; diag += alpha
        dx      <- solve(lambda, eta)
        if |dx| <= threshold: break            # break BEFORE pushing
        x_saved <- x; x <- x ⊞ dx; error <- chi2(x)
        rho = (last_error - error) / (dx . (alpha*dx + eta))
        good: alpha *= max(1/3, 1-(2 rho-1)^3); nu = 2; last_error = error
        bad:  alpha *= nu; nu *= 2; x <- x_saved;
              if fail: fail -= 1; max_iters += 1

``SolverSettings.damping_init`` replaces the derived initial alpha (the
JAX package's ``SolverConfig.damping_init``).

Each trial (damp, the GN solver's linear solve — the dense or the
sparse-reduced Schur, the dense factor or the block Cholesky —, ⊞,
re-assembly at the new point, the rho scalars) runs on the device and ends
in ONE host sync that reads |dx|, the new chi2 and the rho denominator
together (a float32 block Cholesky adds one read of its bottom factor's
status).  ``solver._schur.sparse_reduced`` tells which Schur branch a BA
problem takes.

Tracer spans (utils/timer.py, off by default): ``lm.optimize`` around a
run, ``lm.trial``, ``lm.update`` and ``host_sync`` (each read of a device
value) in it; the assembler, the Schur and the block Cholesky add their own.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from slam_plus_plus_tpu_torch.assembly.assembler import BlockSystem
from slam_plus_plus_tpu_torch.config import SolverSettings
from slam_plus_plus_tpu_torch.graph.system import GraphSystem
from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
from slam_plus_plus_tpu_torch.utils.timer import span


def damp_system(system: BlockSystem, alpha, pp_diag_ids) -> BlockSystem:
    """lambda.diag += alpha (reference ApplyDamping,
    NonlinearSolver_Lambda_LM.h:228-243).  Blocks are planar [K, B*B];
    alpha is a float or a 0-dim tensor on the blocks' device."""
    pp, ll = system.pp_blocks.clone(), system.ll_blocks.clone()
    Bp = math.isqrt(pp.shape[-1])
    Bl = math.isqrt(ll.shape[-1])
    pp[pp_diag_ids[:, None], torch.arange(Bp, device=pp.device) * (Bp + 1)] += alpha
    ll[:, torch.arange(Bl, device=ll.device) * (Bl + 1)] += alpha
    return system._replace(pp_blocks=pp, ll_blocks=ll)


class LevenbergMarquardtSolver(GaussNewtonSolver):
    TAU = 1e-3  # reference f_InitialDamping tau (Lambda_LM.h:155)

    def _trial(self, states, base: BlockSystem, alpha: float):
        asm = self.asm
        damped = damp_system(base, alpha, asm.pp_diag_ids_dev)
        dx_p, dx_l = self._solve(damped)
        dx_norm = torch.sqrt(torch.sum(dx_p * dx_p) + torch.sum(dx_l * dx_l))
        with span("lm.update"):
            new_states = asm.update(states, dx_p, dx_l)
        new_sys = asm.assemble(new_states)
        denom = (torch.sum(dx_p * (alpha * dx_p + base.eta_p)) +
                 torch.sum(dx_l * (alpha * dx_l + base.eta_l)))
        return new_states, new_sys, dx_norm, new_sys.chi2, denom

    def optimize(self, max_iterations: int = 5, dx_threshold: float = 0.01,
                 verbose: bool = False):
        """Run LM; writes the optimized states back to the system.  The
        defaults are the reference's final-optimization settings.

        Returns (final_chi2, iterations_run).  ``self.trial_log`` keeps
        (|dx|, trial chi2, rho denominator) of every trial of the run,
        ``self.initial_chi2`` the chi2 it started from."""
        with span("lm.optimize"):
            return self._optimize(max_iterations, dx_threshold, verbose)

    def _optimize(self, max_iterations, dx_threshold, verbose):
        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)
        base = asm.assemble(states)

        with span("host_sync"):
            alpha = float(base.max_hdiag) * self.TAU
        if self.settings.damping_init:
            alpha = self.settings.damping_init
        nu = 2.0
        fail = 10
        with span("host_sync"):
            last_error = self.initial_chi2 = float(base.chi2)
        if verbose:
            print(f"alpha: {alpha:f}\ninitial chi2: {last_error:f}")

        self.trial_log = []
        n_iters = 0
        it = 0
        while it < max_iterations:
            it += 1
            n_iters += 1
            with span("lm.trial"):
                new_states, new_sys, norm_d, err_d, den_d = self._trial(states, base, alpha)
                read = torch.stack([norm_d, err_d, den_d])
            with span("host_sync"):
                dx_norm, error, denom = read.tolist()
            self.trial_log.append((dx_norm, error, denom))
            if not math.isfinite(dx_norm):
                break
            if dx_norm <= dx_threshold:
                break  # reference: break before pushing (Lambda_LM.h:1054)
            saved_states = states
            states = new_states
            if verbose:
                print(f"iter {it - 1}: chi2: {error:f} |dx|={dx_norm:.6f} "
                      f"alpha={alpha:g}")
            rho = (last_error - error) / denom if denom != 0.0 else -1.0
            if rho > 0:
                alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
                last_error = error
                base = new_sys
            else:
                alpha *= nu
                nu *= 2.0
                states = saved_states
                if fail > 0:
                    fail -= 1
                    max_iterations += 1

        chi2_dev = asm.chi2(states)
        with span("host_sync"):
            chi2 = float(chi2_dev)
        asm.writeback_states(self.system, states)
        self.timing["optimize"] = time.perf_counter() - t0
        return chi2, n_iters


def optimize_lm(system: GraphSystem, *, device, settings: Optional[SolverSettings] = None,
                max_iterations: int = 5, dx_threshold: float = 0.01, verbose: bool = False):
    """Build a LevenbergMarquardtSolver over system and run it: (final
    chi2, iterations), the states written back (the JAX ``optimize_lm``)."""
    solver = LevenbergMarquardtSolver(system, device=device, settings=settings)
    return solver.optimize(max_iterations, dx_threshold, verbose=verbose)
