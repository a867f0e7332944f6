"""The repository's headline metric in the port: bench.py's damped Schur step
on the card.

    python -m slam_plus_plus_tpu_torch.bench [--device cuda|cpu]

Port of bench.py (which imports JAX and stays the JAX package's).  The same
workload: the synthetic Venice-analogue BA scene, 100 cameras, 8000 points,
457,543 observations (``make_ba_scene(100, 8000, seed=77)``, cached beside
the built kernels), and the same step: assemble lambda and eta (kernel K1
and the reductions), damp the diagonal by 1e-3 x the largest per-edge
vertex-Hessian diagonal, the dense Schur solve (C^-1, kernel K2's panels,
the reduced camera system and its Cholesky, the back-substitution), the ⊞
update.  One warm-up step, then TIMED_STEPS timed steps on a host clock
that ends in ``torch.cuda.synchronize()``.

Gate: the chi2 after the timed steps <= 1.05 x the reference's converged
222855.82, else exit 1.  vs_baseline = 2331.6 ms (the reference binary,
single core, on the same file; bench.py) / the port's ms per step.

bench.py's incremental extra: manhattan3500 ``-nsp 1 -fL`` by the C++
replay engine on ``--device cpu`` (the incremental deployment), run through
the CLI's code path in a subprocess; its ``fastl_m3500_*`` keys join the
result line.  Its chi2 is gated at 1.05 x the reference's 1418.70, and a
failure of the extra fails the run.

Prints the card's name and power limit (nvidia-smi) on a line of its own,
then, as the last line, one JSON object:

  {"metric": "ba_solve_iter", "value": <ms>, "unit": "ms",
   "vs_baseline": <x>, "breakdown_s": {...}, "fastl_m3500_...": ...}

``breakdown_s``: the port's set-up stages (kernel build, scene file and
parse, plan, first step).  ``--device cuda`` (the default) needs a card and
fails without one; ``--device cpu`` runs the kernels' plain versions in
float64.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REF_MS_PER_ITER = 2331.6    # the reference slam_plus_plus, single core, same file
REF_FINAL_CHI2 = 222855.82
N_CAMS, N_POINTS, SEED = 100, 8000, 77
TIMED_STEPS = 4
DAMPING = 1e-3
#: the incremental extra's acceptance row (io/acceptance.py)
FASTL_ROW = "manhattan3500 -nsp 1 -fL"
FASTL_TIMEOUT_S = 600
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class BenchStep:
    """bench.py's step over a GraphSystem on one device: ``step(states)``
    -> (states after the ⊞ update, chi2 at the linearization point)."""

    def __init__(self, system, device):
        from slam_plus_plus_tpu_torch.assembly.assembler import Assembler
        from slam_plus_plus_tpu_torch.config import pin_precision
        from slam_plus_plus_tpu_torch.linalg.schur import SchurSolver

        pin_precision()
        self.asm = Assembler(system, device=device)
        self.schur = SchurSolver(self.asm)

    def assemble_damped(self, states):
        from slam_plus_plus_tpu_torch.solvers.lm import damp_system

        bs = self.asm.assemble(states)
        return damp_system(bs, bs.max_hdiag * DAMPING, self.asm.pp_diag_ids_dev)

    def __call__(self, states):
        bs = self.assemble_damped(states)
        dx_p, dx_l = self.schur.solve(bs)
        return self.asm.update(states, dx_p, dx_l), bs.chi2


def bench_step(system, device):
    """(step, states0): the timed step over system and its starting states."""
    step = BenchStep(system, device)
    return step, step.asm.snapshot_states(system)


def scene_path() -> str:
    """The bench scene's g2o file, written beside the built kernels on first
    use."""
    from slam_plus_plus_tpu_torch.io import datasets
    from slam_plus_plus_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"bench_ba_{N_CAMS}_{N_POINTS}_{SEED}.txt")
    if not os.path.exists(path):
        cams, pts, obs = datasets.make_ba_scene(n_cams=N_CAMS, n_points=N_POINTS, seed=SEED)
        tmp = f"{path}.{os.getpid()}.tmp"
        datasets.write_g2o_ba(tmp, cams, pts, obs)
        os.replace(tmp, path)
    return path


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout
    return out.strip().splitlines()[0]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def fastl_extra_main(path: str) -> None:
    """The incremental extra, in its own process: FASTL_ROW's replay of
    path by the C++ engine through the CLI's code path; prints one JSON
    line with bench.py's keys."""
    from slam_plus_plus_tpu_torch.app import main as cli
    from slam_plus_plus_tpu_torch.io import acceptance

    _name, flags, _golden, _iters = acceptance.INCREMENTAL_ROWS[FASTL_ROW]
    args = cli.build_argparser().parse_args(
        ["-i", path, "--device", "cpu", "--native", "-s", "-dx", ""] + flags)
    t0 = time.perf_counter()
    chi2, _iters, solver = cli.run(args)
    wall = time.perf_counter() - t0
    fl = getattr(solver, "_delegate", None) or solver
    print(json.dumps(dict(
        fastl_m3500_wall_s=round(wall, 2),
        fastl_m3500_ms_per_applied_step=round(
            wall / max(fl.stats.get("omega_steps", 1), 1) * 1e3, 2),
        fastl_m3500_chi2=round(float(chi2), 2),
        fastl_native=fl._native is not None)))


def fastl_extra() -> dict:
    """Run the extra in a subprocess and gate its chi2; raises on a
    failure."""
    from slam_plus_plus_tpu_torch.io import acceptance
    from slam_plus_plus_tpu_torch.ops import _build

    name, _flags, golden, _iters = acceptance.INCREMENTAL_ROWS[FASTL_ROW]
    path = acceptance.dataset(name, _build.BUILD_DIR)
    code = ("import sys; from slam_plus_plus_tpu_torch.bench import fastl_extra_main; "
            "fastl_extra_main(sys.argv[1])")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=_ROOT, capture_output=True,
                          text=True, timeout=FASTL_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"the FastL extra exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    extra = json.loads(proc.stdout.strip().splitlines()[-1])
    if not extra["fastl_native"]:
        raise RuntimeError("the FastL extra did not run on the C++ engine")
    if not extra["fastl_m3500_chi2"] <= acceptance.GATE * golden:
        raise RuntimeError(f"the FastL extra: chi2 {extra['fastl_m3500_chi2']} > "
                           f"{acceptance.GATE} x {golden}")
    return extra


def run(device) -> dict:
    """The benchmark on device: the result line's dict.  Raises
    RuntimeError when a gate fails."""
    import torch

    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.ops import _build
    from slam_plus_plus_tpu_torch.ops.p2c import p2c_edge_terms
    from slam_plus_plus_tpu_torch.ops.panel import build_panels

    device = torch.device(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.build()
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    system = parse_g2o(scene_path())
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, states = bench_step(system, device)
    t_plan = time.perf_counter() - t0
    print(f"bench scene: {system.num_vertices} vertices, {system.num_edges} edges on "
          f"{device} ({step.asm.dtype}); uniform layout {step.asm.pl_uniform is not None}, "
          f"dense Schur {step.schur.uniform}", file=sys.stderr)

    launches0 = (p2c_edge_terms.launches, build_panels.launches)
    t0 = time.perf_counter()
    _, chi2 = step(states)
    _sync(device)
    t_first = time.perf_counter() - t0
    print(f"first step: {t_first:.2f} s (initial chi2 {float(chi2):.1f})", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        states, chi2 = step(states)
    _sync(device)
    ms_per_iter = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    launches = {"p2c_edge_terms": p2c_edge_terms.launches - launches0[0],
                "build_panels": build_panels.launches - launches0[1]}

    final_chi2 = float(chi2)
    if not final_chi2 <= REF_FINAL_CHI2 * 1.05:
        raise RuntimeError(f"chi2 {final_chi2:.1f} exceeds 1.05 x the reference "
                           f"{REF_FINAL_CHI2}")
    if device.type == "cuda" and not all(launches.values()):
        raise RuntimeError(f"a kernel was not launched on the step: {launches}")
    print(f"chi2 after {TIMED_STEPS} steps: {final_chi2:.1f} (reference converged: "
          f"{REF_FINAL_CHI2}); kernel launches {launches}", file=sys.stderr)

    extra = fastl_extra()
    print(f"fastl m3500 (the C++ engine on the host): {extra}", file=sys.stderr)
    return {
        "metric": "ba_solve_iter",
        "value": round(ms_per_iter, 3),
        "unit": "ms",
        "vs_baseline": round(REF_MS_PER_ITER / ms_per_iter, 2),
        "chi2": round(final_chi2, 2),
        "device": str(device),
        "launches": launches,
        "breakdown_s": {"kernel_build": round(t_build, 2), "scene_parse": round(t_parse, 2),
                        "plan": round(t_plan, 2), "first_step": round(t_first, 2)},
        **extra,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slam_plus_plus_tpu_torch.bench")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("error: --device cuda, but torch sees no CUDA device; run on a GPU or "
                  "pass --device cpu", file=sys.stderr)
            return 2
        print(f"card: {card_line()}")
    try:
        result = run(args.device)
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
