"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the scene from
the seed, written once per (configuration, seed) as a g2o file under
``.bench_cache/`` in the checkout; the program's own parser
(``io/native_parser.parse_g2o_fast``); the solver's construction; the
warm-up.  The window then drives whole units of the cell's traffic back to
back and starts none that would end past ``--seconds`` by the last unit's
time; its end-to-end metric is the window's wall time over the work
completed.  With ``--trace 1`` the window runs as it does untraced, but
clocks each unit's profiled part (a solve, or the traffic's
``profile_part`` of a replay); then the traffic's ``span_units`` units run
inside spans, one more unit runs with its part under torch.profiler with
the device's activities alone (busy time, the idle gaps' CUDA calls, the
kernels), and, where the traffic asks for ``host_op_breakdown``, one more
under the profiler of host operations too, whose idle gaps the breakdown
names; the line carries the per-layer metrics instead.

After the window the program's answer of the last unit is compared with
the plain reference (``benchmark/reference``) that the traffic file names,
or else the configuration's, run in
float64 on the same device once the program's state is freed; each number
is held to its limit in ``limits/<cell>.json``.  The last lines of the
error stream give each number beside its limit, and the result line's last
key, ``checks``, the same.

Exits 2 without a result when torch sees no card (or fewer than the cell
needs), and 3 when jax, jaxlib, flax or slam_plus_plus_tpu is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the checkout's cache: scenes, and the kernel caches a library may keep
CACHE = os.path.join(ROOT, ".bench_cache")
#: top-level module names the program must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_plus_plus_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


class ForbiddenModules(RuntimeError):
    pass


def set_host_threads(n: int) -> None:
    """n threads for the host's math (OpenMP, BLAS, torch's CPU ops), as the
    configuration's ``host_threads`` states; call before torch is first
    imported, for OpenMP to take it."""
    os.environ["OMP_NUM_THREADS"] = str(n)
    import torch

    torch.set_num_threads(n)


def _sync_of(device):
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool, device,
             clock0=None, keep_reference: bool = False) -> dict:
    """One run of a cell on device.  clock0(): seconds since set-up began
    (the process's age when run as a program).  Returns the result line's
    dict; with keep_reference, also the scene and answers under "_".
    Raises ForbiddenModules."""
    from benchmark import drivers, scenes
    from benchmark import trace as tracing
    from benchmark.reference.precision import FLOAT64
    from benchmark.spans import Spans

    if clock0 is None:
        t_begin = time.perf_counter()

        def clock0():
            return time.perf_counter() - t_begin

    cell = spec.workload(workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    split = {}

    t = time.perf_counter()
    scene = scenes.generate(cfg, seed)
    split["scene"] = time.perf_counter() - t
    t = time.perf_counter()
    path = scenes.scene_file(cfg, scene, seed, CACHE)
    split["scene_file"] = time.perf_counter() - t

    import torch

    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast

    sync = _sync_of(device)
    t = time.perf_counter()
    system = parse_g2o_fast(path)
    split["parse"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = drivers.build(system, scene, cfg, traffic, device)
    split["construct"] = time.perf_counter() - t
    print(f"{workload}: {cfg['name']} seed {seed} on {device}: {driver.route()}",
          file=sys.stderr)
    t = time.perf_counter()
    driver.warm_up()
    sync()
    split["warm_up"] = time.perf_counter() - t
    setup_s = clock0()

    # the window: whole units, none started that would end past `seconds`
    units = failed = 0
    last = 0.0
    unit_s, marks = [], []

    def mark():
        sync()
        marks.append(time.perf_counter())

    t_win = time.perf_counter()
    while units == 0 or (time.perf_counter() - t_win) + last <= seconds:
        t = time.perf_counter()
        chi2 = driver.unit((mark, mark) if trace else None)
        sync()
        last = time.perf_counter() - t
        unit_s.append(last)
        units += 1
        failed += not math.isfinite(chi2)
    window_s = time.perf_counter() - t_win
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(", ".join(found))
    answer = driver.answer()
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    print(f"set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in split.items())}); "
          f"window {window_s:.3f} s, {units} units of {traffic['name']} (s: first "
          f"{unit_s[0]:.4f}, median {sorted(unit_s)[len(unit_s) // 2]:.4f}, max "
          f"{max(unit_s):.4f}, last {last:.4f})", file=sys.stderr)

    metrics, breakdown = {}, None
    counts = driver.counts()
    if trace:
        spans = Spans(sync)
        layers = driver.layers()
        for name, (obj, method) in layers.items():
            spans.wrap(name, obj, method)
        for _ in range(int(traffic["span_units"]) if layers else 0):
            driver.unit()
        spans.unwrap()
        tr, wall = tracing.profile(driver.unit, sync, cuda, host_ops=False)
        part_s = sorted(b - a for a, b in zip(marks[::2], marks[1::2]))[units // 2]
        print(f"profiled part (device activities) {wall:.3f} s, {wall / part_s:.4f}x the "
              f"window's median part", file=sys.stderr)
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        breakdown = tr.breakdown()
        if traffic.get("host_op_breakdown"):
            host_tr, wall = tracing.profile(driver.unit, sync, cuda, host_ops=True)
            print(f"profiled part (host operations) {wall:.3f} s", file=sys.stderr)
            breakdown["idle_gaps"] = host_tr.breakdown()["idle_gaps"]
        from types import SimpleNamespace

        ctx = SimpleNamespace(trace=tr, part_s=part_s, part_work=driver.part_work,
                              spans=dict(spans.times),
                              construct_s=driver.construct_s, counts=counts,
                              itemsize=torch.empty((), dtype=drivers.expected_dtype(
                                  cfg, device)).element_size())
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(workload):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == traffic["metric"]:
                value = window_s * 1e3 / (units * driver.work_per_unit)
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the program's state freed, the reference in float64
    del driver, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_mod = importlib.import_module(
        f"benchmark.reference.{traffic.get('reference', cfg['reference'])}")
    t = time.perf_counter()
    ref = ref_mod.solve(scene.as_read(), traffic, FLOAT64, device)
    t_ref = time.perf_counter() - t
    numbers = ref_mod.compare(answer, ref)
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in numbers.items()}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    print(f"reference {t_ref:.3f} s; program chi2 {answer['chi2']!r}, reference "
          f"{ref['chi2']!r}; counts {counts}", file=sys.stderr)

    result = {"correct": correct, "attempted": units, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_split_s"] = split
    result["checks"] = checks
    if keep_reference:
        result["_"] = dict(scene=scene, answer=answer, ref=ref, traffic=traffic,
                           ref_mod=ref_mod, cfg=cfg)
    return result


def print_checks(checks: dict) -> None:
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches of any library that compiles kernels: fixed, inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    from benchmark.spec import Spec

    spec = Spec()
    cell = spec.workload(args.workload)
    set_host_threads(int(spec.config(cell["config"])["host_threads"]))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    try:
        result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda", clock0=process_age)
    except ForbiddenModules as e:
        print(f"error: loaded after the window: {e}", file=sys.stderr)
        return 3
    watts = card.rsplit(",", 1)[-1].strip().split(" ")[0]
    if watts.replace(".", "", 1).isdigit():
        result["device"]["power_limit_w"] = float(watts)   # beside every rate and share
    found = forbidden_modules()
    if found:
        print(f"error: loaded by the end of the run: {', '.join(found)}", file=sys.stderr)
        return 3
    print_checks(result["checks"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
