"""The JAX package's incremental Lambda-DL on the bench scene written as an
incremental BA file: the per-marker chi2, iterations and trust radius.

    JAX_PLATFORMS=cpu python scripts/iba_bench_jax_trace.py [n_markers]

The file is make_ba_scene(100, 8000, seed=77) written by the JAX package's
write_incremental_ba with two cameras per marker (50 markers), the file
phase 12 (b) of chip_smoke.py writes with the port's byte-identical
writer.  The run is float64 on the CPU and stops after n_markers markers
(default: all).  It shows the JAX package's fault that the port repairs
(ROADMAP.md Queue 3): the trust radius it keeps across markers grows to
1.4e12 by the 10th marker, the 11th marker's rejected GN step cannot bring
it down, and on this file the replay raises an OverflowError in its
trust-radius update at the 50th marker.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import slam_plus_plus_tpu.models  # noqa: E402,F401
from slam_plus_plus_tpu.app.incremental_ba import (parse_with_markers,  # noqa: E402
                                                   write_incremental_ba)
from slam_plus_plus_tpu.io.datasets import make_ba_scene  # noqa: E402
from slam_plus_plus_tpu.solvers.dogleg_incremental import (  # noqa: E402
    IncrementalDoglegSolver)


def main():
    n_markers = int(sys.argv[1]) if len(sys.argv) > 1 else None
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "iba_bench.g2o")
        write_incremental_ba(path, *make_ba_scene(n_cams=100, n_points=8000, seed=77),
                             cams_per_chunk=2)
        system, markers = parse_with_markers(path)
    s = IncrementalDoglegSolver(system)
    t0 = time.perf_counter()
    for k, ms in enumerate([m - 1 for m in markers][:n_markers]):
        s.advance_to(ms)
        chi2, it = s.optimize()
        print(f"marker {k}: chi2 {chi2!r} iterations {it} trust radius {s.delta!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
