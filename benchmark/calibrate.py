"""Readings that set a cell's limits, in one process: the program's numbers
over many seeds (each a run of the cell with a short window), and, on the
first seeds, the control's: the reference in the configuration's next
lower precision (``control``) put in the program's place and compared with
the float64 reference by the same numbers.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --controls 3 \
        --seconds 1 [--out FILE]

One JSON line per seed: the program's numbers, and the control's where run.
Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import run
    from benchmark.spec import Spec

    spec = Spec()
    run.set_host_threads(int(spec.config(spec.workload(args.workload)["config"])["host_threads"]))
    import torch

    from benchmark.reference.precision import PRECISIONS

    if not torch.cuda.is_available():
        print("error: calibration needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run.run_cell(spec, args.workload, seed, args.seconds, False, "cuda",
                         keep_reference=True)
        keep = r.pop("_")
        line = {"seed": seed, "correct": r["correct"],
                "program": {n: c["value"] for n, c in r["checks"].items()},
                "metrics": {n: m["value"] for n, m in r["metrics"].items()},
                "peak_bytes": r["device"]["memory_peak_bytes"]}
        if k < args.controls:
            ref_mod, cfg = keep["ref_mod"], keep["cfg"]
            t = time.perf_counter()
            ctl = ref_mod.solve(keep["scene"].as_read(), keep["traffic"],
                                PRECISIONS[cfg["control"]], "cuda")
            line["control"] = ref_mod.compare(ref_mod.as_answer(ctl), keep["ref"])
            line["control_s"] = time.perf_counter() - t
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del keep, r
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
