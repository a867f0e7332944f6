"""Closed-loop batch solves, one caller: restore the parsed initial
estimate and run one whole ``optimize(iterations, dx_threshold)`` of the
solver built in set-up, back to back.  Each solve uploads the states, runs
every iteration and writes the states back to the host graph.

The traffic's ``solver`` is ``lm`` (the CLI's BA default, Lambda-LM) or
``gn`` (Gauss-Newton, the CLI's ``-po``); either is built with its default
settings, so the program picks its own linear solver and dtype."""

from __future__ import annotations

from benchmark import drivers


class BatchDriver:
    def __init__(self, system, scene, config, traffic, device):
        from slam_plus_plus_tpu_torch.solvers.gauss_newton import GaussNewtonSolver
        from slam_plus_plus_tpu_torch.solvers.lm import LevenbergMarquardtSolver

        solvers = {"lm": LevenbergMarquardtSolver, "gn": GaussNewtonSolver}
        if traffic["solver"] not in solvers:
            raise ValueError(f"batch driver: no solver {traffic['solver']!r}")
        self.system, self.scene = system, scene
        self.iterations = int(traffic["iterations"])
        self.dx_threshold = float(traffic["dx_threshold"])
        self.solver = solvers[traffic["solver"]](system, device=device)
        want = drivers.expected_dtype(config, device)
        if self.solver.asm.dtype != want:
            raise RuntimeError(f"the program solves in {self.solver.asm.dtype}; the "
                               f"configuration states {want}")
        self.initial = drivers.snapshot(system)
        self.construct_s = self.solver.timing["construct"]
        self.work_per_unit = self.part_work = 1
        self.chi2 = float("nan")

    def route(self) -> str:
        solver = self.solver
        asm, schur = solver.asm, solver._schur
        taken = [n for n in ("_schur", "_sparse_chol", "_dense", "_host")
                 if getattr(solver, n) is not None]
        parts = [f"{type(solver).__name__}", f"{asm.dtype}", f"linear solver {', '.join(taken)}",
                 f"uniform layout (K1) {asm.k1}"]
        if solver._sparse_chol is not None:
            chol = solver._sparse_chol
            parts += [f"block Cholesky levels {chol.n_levels}, bottom {chol.plan.n_bottom}",
                      f"PCG {solver.pcg_iterations}"]
        if schur is not None:
            parts.append(f"sparse-reduced Schur {schur.sparse_reduced}")
            if schur.sparse_reduced:
                chol = schur.reduced_chol
                parts += [f"clique path {schur.clique}", f"SC blocks {schur.Ksc}",
                          f"block Cholesky levels {chol.n_levels}, bottom {chol.plan.n_bottom}"]
        return ", ".join(parts)

    def warm_up(self):
        self.unit()

    def unit(self, part=None) -> float:
        drivers.restore(self.system, self.initial)
        if part:
            part[0]()
        self.chi2, _ = self.solver.optimize(self.iterations, self.dx_threshold)
        if part:
            part[1]()
        return self.chi2

    def answer(self) -> dict:
        return {**drivers.by_id(self.system), "chi2": self.chi2}

    def layers(self) -> dict:
        solver = self.solver
        out = {"assemble": (solver.asm, "assemble")}
        schur = solver._schur
        if schur is not None:
            out["schur"] = (schur, "solve")
            if schur.sparse_reduced:
                out["factor"] = (schur.reduced_chol, "solve")
        elif solver._sparse_chol is not None:
            # the pose graph's block Cholesky: factor and solve of an iteration
            out["factor"] = (solver, "_solve")
        return out

    def counts(self) -> dict:
        from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms

        return {"observations": int(getattr(self.scene, "n_obs", 0)),
                "k1_launches": p2c_edge_terms.launches,
                "k1_engaged": bool(self.solver.asm.k1)}


def build(system, scene, config, traffic, device):
    return BatchDriver(system, scene, config, traffic, device)
