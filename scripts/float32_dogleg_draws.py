"""Draws of the float32 dogleg on chip_smoke.py phase 8 (b)'s stereo file.

    python scripts/float32_dogleg_draws.py port cuda N       # the CLI's card path (float64), N runs
    python scripts/float32_dogleg_draws.py port cpu N [FIRST] # the port's float32 on the CPU
    JAX_PLATFORMS=cpu python scripts/float32_dogleg_draws.py jax cpu N [FIRST]
    python scripts/float32_dogleg_draws.py cond cpu N [FIRST]   # the first GN step's conditioning

The file is make_ba_scene(n_cams=8, n_points=150, seed=30) written by
write_g2o_ba_stereo with make_ba_stereo_obs(seed=31), as phase 8 (b)
writes it; each run is `-dl -mfnsi 30` (30 iterations, dx threshold 0.01)
held against the float64 CPU chi2 at phase 8 (b)'s 1e-4 relative.  On the
card the draws come from the float32 atomic sums of one process's
repeated runs.  On the CPU, where float32 runs repeat bitwise, draw k
scales every vertex state by 1 + N(0, 1e-7) drawn from seed k (the same
states in both packages), so the two packages can be compared draw for
draw.  Prints each miss with its dogleg trace and a summary line.  `cond`
prints, per draw at the starting states, the condition number of the
reduced camera system the first GN step solves (with the dogleg's 1e-9 x
max-diagonal jitter, which every GN solve of this file takes: one point
has no observation) and the step's camera-part norm in float64, in
float32, and by a float64 solve of the float32 reduced system.  The
summary line names the dtype of the solvers that ran: the CLI's dogleg
on the card runs float64 (config.float64_dtype), so `port cuda` draws
the float64 dogleg.
"""

import collections
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GATE = 1e-4
PERTURB = 1e-7


def write_file(path):
    from slam_plus_plus_tpu_torch.io import datasets as D
    cams, pts, _obs = D.make_ba_scene(n_cams=8, n_points=150, seed=30)
    D.write_g2o_ba_stereo(path, cams, pts, D.make_ba_stereo_obs(cams, pts, seed=31))


def float64_chi2(path):
    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.dogleg import DoglegSolver
    return DoglegSolver(parse_g2o(path), device="cpu").optimize(30)[0]


def perturbed(system, k):
    rng = np.random.default_rng(k)
    for st in system.vertex_stores.values():
        st.data[:st.n] *= 1 + rng.normal(0, PERTURB, st.data[:st.n].shape)
    return system


def run_once(package, device, path, k):
    """(chi2, iterations, the dogleg's printed trace, the solver's dtype)
    of draw k."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if package == "jax":
            import slam_plus_plus_tpu.models  # noqa: F401
            from slam_plus_plus_tpu.io.parser import parse_g2o
            from slam_plus_plus_tpu.solvers.dogleg import DoglegSolver
            solver = DoglegSolver(perturbed(parse_g2o(path), k))
            chi2, iters = solver.optimize(30, verbose=True)
        elif device == "cuda":
            from slam_plus_plus_tpu_torch.app import main as cli
            args = cli.build_argparser().parse_args(
                ["-i", path, "--device", "cuda", "-v", "-dx", "", "-dl", "-mfnsi", "30"])
            chi2, iters, solver = cli.run(args)
        else:
            import torch

            from slam_plus_plus_tpu_torch.io.parser import parse_g2o
            from slam_plus_plus_tpu_torch.solvers.dogleg import DoglegSolver
            solver = DoglegSolver(perturbed(parse_g2o(path), k), device="cpu",
                                  dtype=torch.float32)
            chi2, iters = solver.optimize(30, verbose=True)
    trace = [ln for ln in buf.getvalue().splitlines() if ln.startswith("iter ")]
    dt = str(solver.asm.dtype)
    return float(chi2), iters, trace, (dt[6:] if dt.startswith("torch.") else
                                       np.dtype(solver.asm.dtype).name)


def conditioning(path, k):
    """Line of draw k's first GN step: kappa of the jittered reduced
    system and |dx_p| three ways."""
    import torch

    from slam_plus_plus_tpu_torch.io.parser import parse_g2o
    from slam_plus_plus_tpu_torch.solvers.dogleg import DoglegSolver
    from slam_plus_plus_tpu_torch.solvers.lm import damp_system
    out = {}
    for dt in (torch.float64, torch.float32):
        s = DoglegSolver(perturbed(parse_g2o(path), k), device="cpu", dtype=dt)
        bs = s.asm.assemble(s.asm.snapshot_states(s.system))
        bs = damp_system(bs, float(bs.max_hdiag) * 1e-9, s.asm.pp_diag_ids_dev)
        _c_inv, _u, _w, sc, rhs = s._schur._flat_reduce(bs)
        out[dt] = (sc.double(), rhs.double().reshape(-1), s._solve(bs)[0].double().norm())
    ev = torch.linalg.eigvalsh(out[torch.float64][0])
    sc32, rhs32, _ = out[torch.float32]
    mixed = torch.linalg.solve(sc32, rhs32).norm()
    return (f"draw {k}: kappa {float(ev[-1] / ev[0]):.3e}; |dx_p| float64 "
            f"{float(out[torch.float64][2]):.4f}, float32 {float(out[torch.float32][2]):.4f}, "
            f"float64 solve of the float32 system {float(mixed):.4f}")


def main(argv):
    package, device, n = argv[0], argv[1], int(argv[2])
    first = int(argv[3]) if len(argv) > 3 else 0
    if package == "cond":
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "stereo.g2o")
            write_file(path)
            for k in range(first, first + n):
                print(conditioning(path, k), flush=True)
        return
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stereo.g2o")
        write_file(path)
        want = float64_chi2(path)
        its, errs, dtypes = collections.Counter(), [], set()
        t0 = time.perf_counter()
        for k in range(first, first + n):
            chi2, iters, trace, dtype = run_once(package, device, path, k)
            dtypes.add(dtype)
            err = abs(chi2 - want) / want
            errs.append(err)
            its[iters] += 1
            if err > GATE:
                print(f"miss, draw {k}: chi2 {chi2:.6f} in {iters} iterations, {err:.3e} relative")
                print("\n".join("  " + ln for ln in trace), flush=True)
    misses = sum(e > GATE for e in errs)
    print(f"{package} {', '.join(sorted(dtypes))} on {device}: {misses} of {n} draws miss "
          f"{GATE:g} relative of the "
          f"float64 {want:.6f}; largest {max(errs):.3e}; iterations "
          f"{dict(sorted(its.items()))}; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
