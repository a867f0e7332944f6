"""The device trace of a traced run, reduced to what the per-layer readers
and the result line need.

busy: the union of the device activities' intervals; window: from the
first to the last activity of any kind in the trace; idle share = 1 -
busy / window.  An idle gap is a stretch of the window in which the device
runs nothing; it is put down to the innermost host operation running at its
middle, or to the host's own work outside any traced call.  The profile
of the device's activities alone holds, on the host's side, the CUDA calls
only: it stretches the profiled part least and names a gap by the CUDA call (a
launch, a synchronisation) or by the host's own work; the profile of host
operations names it by the operator.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np

#: host operations looked at, innermost first, when naming a gap
GAP_LOOKBACK = 256
#: a gap's name where no traced host call runs at its middle
HOST_OWN = "host, outside traced calls"
#: characters of a name kept in the breakdown
NAME_CHARS = 160


@dataclass
class Trace:
    busy_s: float
    window_s: float
    n_device: int                                  # device activities
    device_s: dict = field(default_factory=dict)   # name -> summed seconds
    device_n: dict = field(default_factory=dict)   # name -> activities
    gaps_s: dict = field(default_factory=dict)     # host op -> idle seconds

    def kernels(self, pattern: str):
        """(activities, summed seconds) of the device activities whose name
        holds pattern."""
        n = sum(c for k, c in self.device_n.items() if pattern in k)
        return n, sum(s for k, s in self.device_s.items() if pattern in k)

    def breakdown(self) -> dict:
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:NAME_CHARS], v] for k, v in top],
                "idle_gaps": [[k[:NAME_CHARS], v] for k, v in gaps]}


def idle_pct(trace: Trace, part_s: float):
    """The device's idle share in percent: 1 - the busy time of a unit's
    profiled part (the union of its device activities' intervals) over the
    wall time of that part untraced, the median of the same run's window.
    The profiled part's own wall would count what the profiler adds to the
    host's time as idle.  None where the trace holds no device activity."""
    if not trace.n_device or part_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / part_s)


def summarize(events) -> Trace:
    """Reduce a profiler's events (``_KinetoEvent``), array-wise: a replay
    leaves millions."""
    from torch.autograd import DeviceType

    names, start, dur, on_dev = [], [], [], []
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
    start, on_dev = np.array(start, dtype=np.int64), np.array(on_dev, dtype=bool)
    end = start + np.array(dur, dtype=np.int64)
    if not on_dev.any():
        return Trace(0.0, 0.0, 0)
    device_s, device_n = {}, {}
    d_idx = np.flatnonzero(on_dev)
    for k, sec in zip(d_idx.tolist(), ((end[d_idx] - start[d_idx]) * 1e-9).tolist()):
        device_s[names[k]] = device_s.get(names[k], 0.0) + sec
        device_n[names[k]] = device_n.get(names[k], 0) + 1
    # the device's busy runs: the union of its intervals
    order = d_idx[np.argsort(start[d_idx], kind="stable")]
    a, b = start[order], np.maximum.accumulate(end[order])
    new = np.concatenate([[True], a[1:] > b[:-1]])
    run_a = a[new]
    run_b = b[np.concatenate([np.flatnonzero(new)[1:] - 1, [len(b) - 1]])]
    busy = int((run_b - run_a).sum())
    lo, hi = int(start.min()), int(end.max())
    gap_a = np.concatenate([[lo], run_b])
    gap_b = np.concatenate([run_a, [hi]])
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    # each gap's innermost host operation at its middle: the latest-starting
    # one that still runs there, among the GAP_LOOKBACK before it
    h_idx = np.flatnonzero(~on_dev)
    h_idx = h_idx[np.argsort(start[h_idx], kind="stable")]
    h_start, h_end = start[h_idx], end[h_idx]
    mid = (gap_a + gap_b) // 2
    at = np.searchsorted(h_start, mid, side="right") - 1
    owner = np.full(len(mid), -1)
    open_ = np.ones(len(mid), dtype=bool)
    for back in range(GAP_LOOKBACK):
        j = at - back
        hit = open_ & (j >= 0) & (h_end[np.maximum(j, 0)] >= mid) if len(h_end) else open_ & False
        owner[hit] = j[hit]
        open_ &= ~hit
        if not open_.any():
            break
    gaps_s = {}
    for o, sec in zip(owner.tolist(), ((gap_b - gap_a) * 1e-9).tolist()):
        name = names[h_idx[o]] if o >= 0 else HOST_OWN
        gaps_s[name] = gaps_s.get(name, 0.0) + sec
    return Trace(busy * 1e-9, (hi - lo) * 1e-9, len(d_idx), device_s, device_n, gaps_s)


def profile(unit, sync, cuda: bool, host_ops: bool):
    """(Trace, host seconds) of the profiled part of one unit: ``unit(part)``
    calls part's begin and end around it, and the profiler runs between
    them, the device synchronised at both: with cuda, the device's
    activities and, with host_ops, the host's operations too (always on the
    CPU).  The profiler is stopped by its own ``_disable_profiler``, which
    hands back the raw events: the context manager's exit would first build
    a Python object per event, minutes for a replay's millions."""
    from torch.autograd import profiler

    prof = profiler.profile(use_device="cuda" if cuda else None, use_kineto=True,
                            use_cpu=host_ops or not cuda)
    got = {}

    def begin():
        sync()
        prof.__enter__()
        got["t0"] = time.perf_counter()

    def end():
        sync()
        got["wall"] = time.perf_counter() - got["t0"]
        t1 = time.perf_counter()
        got["result"] = profiler._disable_profiler()
        got["stop"] = time.perf_counter() - t1

    try:
        unit((begin, end))
    finally:
        if "t0" in got and "result" not in got:
            profiler._disable_profiler()
    t2 = time.perf_counter()
    events = got["result"].events()
    t3 = time.perf_counter()
    tr = summarize(events)
    print(f"trace: {len(events)} events; profiler stop {got['stop']:.3f} s, events "
          f"{t3 - t2:.3f} s, reduction {time.perf_counter() - t3:.3f} s", file=sys.stderr)
    return tr, got["wall"]
