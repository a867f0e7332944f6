"""The program's own spans and counters (``slam_plus_plus_tpu_torch.utils.timer``)
read against a device trace, for one cell of BENCHMARK.json:

    python3 -m benchmark.program_spans --workload <cell> --seed <n>

It builds the cell as ``benchmark/run.py`` does (the scene from the seed,
the program's parser, the solver, the warm-up), then runs:

  1. the traffic's ``span_units`` units (one where it names none) with
     the tracer off: the yardstick;
  2. as many units with the tracer on and nothing else: the spans' host
     times;
  3. one unit with its profiled part under torch.profiler with the
     device's activities alone and, where the traffic asks for
     ``host_op_breakdown``, one more under the profiler of host operations
     too, both with the tracer on.

The drained clock anchor (unix ns = perf-counter ns + anchor) moves the
spans onto the trace's clock.  Each device activity is credited to the
innermost span open when its launch call started (the CUDA runtime or
driver call with the same correlation id), and each idle gap is named
``<innermost span at its middle> · <the CUDA call or operator>``, the
second part as ``benchmark/trace.py`` names the gap.

Stderr gets the span table (per span name: calls a unit, host and self ms
a call; in each profiled part the calls, the device ms and activities
launched inside, descendants included, and the CUDA *Synchronize calls),
the block Cholesky per level, the counters, the named idle gaps, the
shares credited and named, and the tracer's cost on this host.  Stdout
gets one JSON line with the readings (``READINGS``) and what they rest on.
``benchmark/run.py`` does not run this: its result line carries none of
these readings.

Exits 2 when torch sees no card, 3 when the program has no tracer.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark import trace as tracing

#: the solve points' percentile (1,197 a replay of Olson's M3500: ~60 past it)
SOLVE_POINT_PCT = 95
#: joins a gap's program span to its host call
SEP = " · "
#: idle gaps printed, the largest first
TOP_GAPS = 16
#: per end-to-end metric of the traffic: (reading, span whose device time
#: it sums, span whose calls in the profiled part it is divided by)
READINGS = {
    "inc_ms_per_pose": [("refresh_dev_ms.inc", "inc.refresh", "fastl.solve_point")],
    "solve_ms": [("assemble_dev_ms.ba", "asm.assemble", "asm.assemble"),
                 ("schur_dev_ms.ba", "schur.solve", "schur.solve"),
                 ("sc_fill_dev_ms.ba", "schur.sc_fill", "schur.sc_fill"),
                 ("factor_dev_ms.ba", "schur.factor", "schur.factor")],
}


class NoTracer(RuntimeError):
    pass


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from slam_plus_plus_tpu_torch.utils import timer
    except ImportError:
        return None
    return timer if all(hasattr(timer, f) for f in ("enable", "disable", "drain")) else None


def record(timer, fn):
    """fn() with the tracer on: (its result, the drained records as Spans)."""
    timer.enable()
    try:
        out = fn()
    finally:
        rec = timer.drain()
        timer.disable()
    return out, Spans(rec)


class Spans:
    """Drained records, array-wise: ``name[i]``, ``id``, ``parent``,
    ``t0`` / ``t1`` (perf-counter ns), ``attrs[i]``, and ``counts``."""

    def __init__(self, rec: dict):
        sp = sorted(rec["spans"], key=lambda s: s.id)       # parents before children
        self.name = [s.name for s in sp]
        self.attrs = [s.attrs for s in sp]
        self.id = np.array([s.id for s in sp], dtype=np.int64)
        self.t0 = np.array([s.t0 for s in sp], dtype=np.int64)
        self.t1 = np.array([s.t1 for s in sp], dtype=np.int64)
        index = {int(i): k for k, i in enumerate(self.id)}
        # a parent outside the records (not drained yet) counts as none
        self.parent = np.array([index.get(s.parent, -1) for s in sp], dtype=np.int64)
        self.depth = np.zeros(len(sp), dtype=np.int64)
        for k, p in enumerate(self.parent.tolist()):
            if p >= 0:
                self.depth[k] = self.depth[p] + 1
        self.counts = list(rec["counts"])
        a0, a1 = rec["anchor_ns"]
        self.anchor_ns = (a0 + a1) // 2
        self.drift_ns = a1 - a0
        self._timeline = None

    def __len__(self):
        return len(self.name)

    def of(self, name: str) -> np.ndarray:
        """Indices of the spans named name."""
        return np.array([k for k, n in enumerate(self.name) if n == name], dtype=np.int64)

    def ms(self, name: str) -> np.ndarray:
        k = self.of(name)
        return (self.t1[k] - self.t0[k]) * 1e-6

    def below(self, name: str, inner: str) -> np.ndarray:
        """ms of each span named name less its descendants named inner."""
        k = self.of(name)
        pos = {int(j): m for m, j in enumerate(k)}
        less = np.zeros(len(k))
        for j in self.of(inner).tolist():
            p = self.parent[j]
            while p >= 0 and int(p) not in pos:
                p = self.parent[p]
            if p >= 0:
                less[pos[int(p)]] += (self.t1[j] - self.t0[j]) * 1e-6
        return (self.t1[k] - self.t0[k]) * 1e-6 - less

    def self_ms(self) -> np.ndarray:
        """Each span's ms less its children's."""
        own = (self.t1 - self.t0).astype(np.float64)
        kids = self.parent >= 0
        np.subtract.at(own, self.parent[kids], (self.t1 - self.t0)[kids])
        return own * 1e-6

    def innermost(self, t_ns: np.ndarray) -> np.ndarray:
        """For each perf-counter time, the innermost span open then, or -1."""
        if self._timeline is None:
            # a sweep over every start and end: between two boundaries the
            # innermost open span is one; at equal times ends go first, the
            # deepest first, and starts the shallowest first
            # (a span of zero length owns no time and is left out)
            keep = np.flatnonzero(self.t1 > self.t0).tolist()
            ev = sorted([(int(self.t0[k]), 1, int(self.depth[k]), k) for k in keep] +
                        [(int(self.t1[k]), 0, -int(self.depth[k]), k) for k in keep])
            at, owner, stack = [], [], []
            for t, opening, _d, k in ev:
                if opening:
                    stack.append(k)
                else:
                    stack.pop()
                at.append(t)
                owner.append(stack[-1] if stack else -1)
            self._timeline = (np.array(at, dtype=np.int64), np.array(owner, dtype=np.int64))
        at, owner = self._timeline
        j = np.searchsorted(at, np.asarray(t_ns, dtype=np.int64), side="right") - 1
        return np.where(j >= 0, owner[np.maximum(j, 0)], -1)

    def chain_names(self, k: int):
        """The distinct names on span k's chain of ancestors, k included."""
        names = set()
        while k >= 0:
            names.add(self.name[k])
            k = int(self.parent[k])
        return names


@dataclass
class Attribution:
    """A profiled part read by the program's spans: per span name, over the
    spans that started in the trace's window, the device seconds and
    activities launched inside them (descendants included), their CUDA
    *Synchronize calls and the calls; the idle gaps by their names."""
    n_device: int = 0                              # device activities
    n_linked: int = 0                              # ... with a launch call
    n_credited: int = 0                            # ... credited to a program span
    span_dev_s: dict = field(default_factory=dict)
    span_dev_n: dict = field(default_factory=dict)
    span_syncs: dict = field(default_factory=dict)
    span_calls: dict = field(default_factory=dict)
    levels: dict = field(default_factory=dict)     # (phase, level) -> [calls, s, n]
    gaps_s: dict = field(default_factory=dict)     # "<span> · <call>" -> idle seconds
    idle_s: float = 0.0
    idle_below_root_s: float = 0.0                 # named by a span below a root
    anchor_check_us: tuple = ()                    # see attribute()


def _arrays(events):
    """Names, start and end (ns), on-device flags and correlation ids of a
    profiler's events (``_KinetoEvent``), array-wise."""
    from torch.autograd import DeviceType

    names, start, dur, on_dev, corr = [], [], [], [], []
    ns = events and hasattr(events[0], "start_ns")
    for e in events:
        names.append(e.name())
        if ns:
            start.append(e.start_ns())
            dur.append(e.duration_ns())
        else:
            start.append(int(e.start_us() * 1000))
            dur.append(int(e.duration_us() * 1000))
        on_dev.append(e.device_type() == DeviceType.CUDA)
        corr.append(e.correlation_id())
    start = np.array(start, dtype=np.int64)
    return (names, start, start + np.array(dur, dtype=np.int64),
            np.array(on_dev, dtype=bool), np.array(corr, dtype=np.int64))


def _gaps(names, start, end, on_dev):
    """The device's idle gaps [a, b) in the trace's window, and each one's
    name as benchmark/trace.py gives it: the innermost host call running at
    its middle (the latest-starting one still running, among the
    GAP_LOOKBACK before it), or the host's own work."""
    d = np.flatnonzero(on_dev)
    order = d[np.argsort(start[d], kind="stable")]
    a, b = start[order], np.maximum.accumulate(end[order])
    new = np.concatenate([[True], a[1:] > b[:-1]])
    run_b = b[np.concatenate([np.flatnonzero(new)[1:] - 1, [len(b) - 1]])]
    gap_a = np.concatenate([[start.min()], run_b])
    gap_b = np.concatenate([a[new], [end.max()]])
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    mid = (gap_a + gap_b) // 2
    h = np.flatnonzero(~on_dev)
    h = h[np.argsort(start[h], kind="stable")]
    h_end = end[h]
    at = np.searchsorted(start[h], mid, side="right") - 1
    owner = np.full(len(mid), -1)
    open_ = np.ones(len(mid), dtype=bool)
    for back in range(tracing.GAP_LOOKBACK if len(h) else 0):
        j = at - back
        hit = open_ & (j >= 0) & (h_end[np.maximum(j, 0)] >= mid)
        owner[hit] = j[hit]
        open_ &= ~hit
        if not open_.any():
            break
    calls = [names[h[o]] if o >= 0 else tracing.HOST_OWN for o in owner.tolist()]
    return gap_a, gap_b, calls


def attribute(events, program: Spans, probe=None) -> Attribution:
    """A profiled part's events read by the spans recorded over it (see the
    module's docstring).  probe: the host's perf-counter ns before and
    after the part's closing device synchronization, to check the anchor
    against (``anchor_check_us``: both margins >= 0 where it holds)."""
    out = Attribution()
    names, start, end, on_dev, corr = _arrays(events)
    d_idx = np.flatnonzero(on_dev)
    out.n_device = len(d_idx)
    if not out.n_device or not len(program):
        return out
    off = program.anchor_ns
    # each device activity's launch call: a CUDA runtime or driver call
    # (cuda*, cu*) of the same correlation id
    l_idx = np.array([k for k in np.flatnonzero(~on_dev).tolist() if names[k].startswith("cu")],
                     dtype=np.int64)
    d_t = np.full(len(d_idx), -1, dtype=np.int64)
    if len(l_idx):
        order = np.argsort(corr[l_idx], kind="stable")
        lc, ls = corr[l_idx][order], start[l_idx][order]
        pos = np.minimum(np.searchsorted(lc, corr[d_idx]), len(lc) - 1)
        hit = lc[pos] == corr[d_idx]
        d_t[hit] = ls[pos[hit]]
    linked = d_t >= 0
    d_own = np.where(linked, program.innermost(d_t - off), -1)
    out.n_linked, out.n_credited = int(linked.sum()), int((d_own >= 0).sum())
    d_sec = (end[d_idx] - start[d_idx]) * 1e-9
    got = d_own >= 0
    n_span = len(program)
    own_s = np.bincount(d_own[got], weights=d_sec[got], minlength=n_span)
    own_n = np.bincount(d_own[got], minlength=n_span)
    syncs = [k for k in l_idx.tolist() if "Synchronize" in names[k]]
    s_own = program.innermost(start[syncs] - off) if syncs else np.zeros(0, dtype=np.int64)
    own_sync = np.bincount(s_own[s_own >= 0], minlength=n_span)
    # inclusive sums per name: each span's own credit goes to every distinct
    # name on its chain of ancestors
    for k in np.flatnonzero((own_n > 0) | (own_sync > 0)).tolist():
        for name in program.chain_names(k):
            out.span_dev_s[name] = out.span_dev_s.get(name, 0.0) + float(own_s[k])
            out.span_dev_n[name] = out.span_dev_n.get(name, 0) + int(own_n[k])
            out.span_syncs[name] = out.span_syncs.get(name, 0) + int(own_sync[k])
    # the calls: spans that started in the trace's window
    t0 = program.t0 + off
    for k in np.flatnonzero((t0 >= start.min()) & (t0 <= end.max())).tolist():
        name = program.name[k]
        out.span_calls[name] = out.span_calls.get(name, 0) + 1
        if name == "chol.level":
            row = out.levels.setdefault((program.attrs[k].get("phase"),
                                         program.attrs[k].get("level")), [0, 0.0, 0])
            row[0] += 1
            row[1] += float(own_s[k])
            row[2] += int(own_n[k])
    gap_a, gap_b, calls = _gaps(names, start, end, on_dev)
    gap_s = ((gap_b - gap_a) * 1e-9).tolist()
    for k, call, sec in zip(program.innermost((gap_a + gap_b) // 2 - off).tolist(), calls, gap_s):
        out.idle_s += sec
        name = call if k < 0 else program.name[k] + SEP + call
        out.gaps_s[name] = out.gaps_s.get(name, 0.0) + sec
        if k >= 0 and program.parent[k] >= 0:
            out.idle_below_root_s += sec
    if probe is not None:
        closing = [k for k in l_idx.tolist() if "DeviceSynchronize" in names[k]]
        if closing:
            k = max(closing, key=lambda j: start[j])
            out.anchor_check_us = (float(start[k] - (probe[0] + off)) * 1e-3,
                                   float((probe[1] + off) - end[k]) * 1e-3)
    return out


def profile(unit, sync, cuda: bool, host_ops: bool, timer):
    """(events, Spans, host seconds, probe) of the profiled part of one unit
    run with the tracer on, profiled as ``benchmark/trace.py``'s
    ``profile`` does it: with cuda, the device's activities and, with
    host_ops, the host's operations too (always on the CPU), stopped by the
    profiler's own ``_disable_profiler``.  probe: see ``attribute``."""
    from torch.autograd import profiler

    prof = profiler.profile(use_device="cuda" if cuda else None, use_kineto=True,
                            use_cpu=host_ops or not cuda)
    got = {}

    def begin():
        sync()
        prof.__enter__()
        got["t0"] = time.perf_counter()

    def end():
        got["probe"] = [time.perf_counter_ns()]
        sync()
        got["probe"].append(time.perf_counter_ns())
        got["wall"] = time.perf_counter() - got["t0"]
        got["result"] = profiler._disable_profiler()

    try:
        _, program = record(timer, lambda: unit((begin, end)))
    finally:
        if "t0" in got and "result" not in got:
            profiler._disable_profiler()
    return got["result"].events(), program, got["wall"], tuple(got["probe"])


def readings(metric: str, program: Spans, dev: Attribution) -> dict:
    """READINGS[metric] from the profiled part's attribution, and for
    FastL the solve points of the spans-on units: the p95 of their ms, and
    the mean of their ms less the host_sync spans inside them."""
    out = {}
    ms = program.ms("fastl.solve_point")
    if metric == "inc_ms_per_pose" and len(ms):
        out["solve_point_p95_ms.inc"] = float(np.percentile(ms, SOLVE_POINT_PCT))
        out["solve_point_host_ms.inc"] = float(program.below("fastl.solve_point",
                                                             "host_sync").mean())
    for name, span, per in READINGS.get(metric, []):
        calls = dev.span_calls.get(per, 0)
        if calls and span in dev.span_dev_s:
            out[name] = 1e3 * dev.span_dev_s[span] / calls
    return out


def span_cost_ns(timer, n: int = 100_000):
    """(ns per disabled span, ns per enabled span) of ``with span(...)`` on
    this host, the enabled spans drained and dropped."""
    span = timer.span
    timer.disable()
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("cost"):
            pass
    off = (time.perf_counter_ns() - t) / n
    timer.enable()
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("cost"):
            pass
    on = (time.perf_counter_ns() - t) / n
    timer.drain()
    timer.disable()
    return off, on


def print_table(program: Spans, units: int, traces: dict) -> None:
    """The span table to stderr; traces: {label: Attribution} of the
    profiled parts, the first one's columns in the table."""
    def out(text):
        print(text, file=sys.stderr)

    dev = next(iter(traces.values()), None)
    names = sorted(set(program.name) | (set(dev.span_calls) if dev else set()))
    self_ms = program.self_ms()
    host = {n: [0, 0.0, 0.0] for n in names}
    for k, n in enumerate(program.name):
        host[n][0] += 1
        host[n][1] += (program.t1[k] - program.t0[k]) * 1e-6
        host[n][2] += self_ms[k]
    names.sort(key=lambda n: -host[n][1])
    out(f"program spans ({units} spans-on unit(s); the part profiled with "
        f"{next(iter(traces), '')}):")
    out(f"  {'span':<24} {'calls/unit':>10} {'host ms':>10} {'self ms':>10} | {'calls':>7} "
        f"{'device ms':>10} {'activities':>10} {'syncs':>6}")
    for n in names:
        c, h, s = host[n]
        row = f"  {n:<24} {c / units:>10.1f} {h / max(c, 1):>10.4f} {s / max(c, 1):>10.4f} |"
        if dev is not None:
            row += (f" {dev.span_calls.get(n, 0):>7} {1e3 * dev.span_dev_s.get(n, 0.0):>10.3f} "
                    f"{dev.span_dev_n.get(n, 0):>10} {dev.span_syncs.get(n, 0):>6}")
        out(row)
    if dev is not None and dev.levels:
        out("  block Cholesky per level in the part (phase, level: calls, activities a call, "
            "device ms a call):")
        for (phase, level), (c, sec, n) in sorted(dev.levels.items(),
                                                  key=lambda kv: (str(kv[0][0]), kv[0][1])):
            out(f"    {phase} {level}: {c}, {n / max(c, 1):.1f}, {1e3 * sec / max(c, 1):.4f}")
    totals = {}
    for c in program.counts:
        t = totals.setdefault(c.name, [0, 0])
        t[0] += 1
        t[1] += c.n
    for n, (r, v) in sorted(totals.items()):
        out(f"  counter {n}: {r} records, {v} in all, {v / max(r, 1):.2f} a record")
    out(f"  spans a unit {len(program) / units:.0f}; anchor drift {program.drift_ns} ns")
    for label, tr in traces.items():
        if not tr.n_device:
            continue
        out(f"  {label}: {tr.n_credited} of {tr.n_device} device activities credited to a "
            f"program span ({100 * tr.n_credited / tr.n_device:.3f}%; {tr.n_linked} linked to "
            f"a launch call); idle named by a span below a unit's root {tr.idle_below_root_s:.4f}"
            f" s of {tr.idle_s:.4f} s ({100 * tr.idle_below_root_s / max(tr.idle_s, 1e-12):.2f}"
            f"%); anchor check (us, both >= 0 where it holds) {tr.anchor_check_us}")
        for name, sec in sorted(tr.gaps_s.items(), key=lambda kv: -kv[1])[:TOP_GAPS]:
            out(f"    idle {1e3 * sec:10.3f} ms  {name}")


def profile_cell(spec, workload: str, seed: int, device) -> dict:
    """Build the cell on device and run it as the module's docstring says;
    returns the JSON line's dict.  Raises NoTracer."""
    import torch

    from benchmark import drivers, scenes
    from benchmark.run import CACHE, _sync_of
    from slam_plus_plus_tpu_torch.io.native_parser import parse_g2o_fast

    timer = tracer()
    if timer is None:
        raise NoTracer("the program has no tracer (utils/timer lacks enable / drain)")
    cell = spec.workload(workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    scene = scenes.generate(cfg, seed)
    system = parse_g2o_fast(scenes.scene_file(cfg, scene, seed, CACHE))
    driver = drivers.build(system, scene, cfg, traffic, device)
    sync = _sync_of(device)
    cuda = torch.device(device).type == "cuda"
    driver.warm_up()
    sync()
    n_on = int(traffic.get("span_units", 1))
    unit_s = []
    for _ in range(n_on):
        t = time.perf_counter()
        driver.unit()
        sync()
        unit_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    _, program = record(timer, lambda: [driver.unit() for _ in range(n_on)])
    sync()
    on_s = (time.perf_counter() - t) / n_on
    median = statistics.median(unit_s)
    print(f"{workload} seed {seed} on {device}: {len(unit_s)} units with the tracer off, "
          f"median {median:.4f} s; {n_on} spans-on unit(s) of {on_s:.4f} s, {on_s / median:.4f}x",
          file=sys.stderr)
    traces, walls = {}, {}
    for label, host_ops in (("device activities", False), ("host operations", True)):
        if host_ops and not traffic.get("host_op_breakdown"):
            continue
        events, part, walls[label], probe = profile(driver.unit, sync, cuda, host_ops, timer)
        traces[label] = attribute(events, part, probe)
        print(f"profiled part ({label}) {walls[label]:.3f} s, {len(events)} events",
              file=sys.stderr)
    print_table(program, n_on, traces)
    off_ns, on_ns = span_cost_ns(timer)
    print(f"tracer on this host: {off_ns:.1f} ns a disabled span, {on_ns:.1f} ns an enabled one",
          file=sys.stderr)
    dev = traces["device activities"]
    sp = program.ms("fastl.solve_point")
    if len(sp):
        print(f"solve points: {len(sp)}, median {float(np.median(sp)):.4f} ms, "
              f"p{SOLVE_POINT_PCT} {float(np.percentile(sp, SOLVE_POINT_PCT)):.4f} ms",
              file=sys.stderr)
    return {
        "workload": workload, "seed": seed, "device": device,
        "readings": readings(traffic["metric"], program, dev),
        "unit_s_median": median, "spans_on_unit_s": on_s, "spans_on_over_median": on_s / median,
        "spans_a_unit": len(program) / n_on, "solve_points": len(sp),
        "device_activities_per_work": dev.n_device / driver.part_work,
        "credited_pct": {k: 100 * t.n_credited / t.n_device for k, t in traces.items()
                         if t.n_device},
        "idle_below_root_pct": {k: 100 * t.idle_below_root_s / t.idle_s
                                for k, t in traces.items() if t.idle_s},
        "idle_gaps": {k: [[n, s] for n, s in sorted(t.gaps_s.items(), key=lambda kv: -kv[1])
                          [:TOP_GAPS]] for k, t in traces.items()},
        "anchor_drift_ns": program.drift_ns,
        "span_cost_ns": {"disabled": off_ns, "enabled": on_ns},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.program_spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    from benchmark.run import CACHE, card_line, set_host_threads
    from benchmark.spec import Spec

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    spec = Spec()
    cell = spec.workload(args.workload)
    set_host_threads(int(spec.config(cell["config"])["host_threads"]))
    import torch

    if not torch.cuda.is_available():
        print(f"error: {args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    try:
        result = profile_cell(spec, args.workload, args.seed, "cuda")
    except NoTracer as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
