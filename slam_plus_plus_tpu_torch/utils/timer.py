"""Per-stage timing accumulation, and the port's tracer.

``StageTimer`` ports slam_plus_plus_tpu/utils/timer.py (reference CTimer /
CDeltaTimer / CTimerSampler, include/slam/Timer.h:229-391, and the
per-stage accumulators every solver prints from Dump(), e.g.
m_f_lambda_time, include/slam/NonlinearSolver_Lambda.h:250).  Given a CUDA
device, a stage synchronizes that device before it reads the clock on
exit, so the stage's time includes the kernels it queued; without one it
measures host wall time, as the JAX package's timer does.

The tracer records spans and counters placed inside the solvers, in
memory, on the host's ``time.perf_counter_ns()`` clock:

    from slam_plus_plus_tpu_torch.utils import timer
    timer.enable()
    solver.optimize()                  # spans: lm.optimize, lm.trial, ...
    rec = timer.drain()                # {"spans", "counts", "anchor_ns"}
    timer.disable()

A span records its name, its id, its parent's id (0 at a root), the id of
its unit (the root span open around it: one ``optimize`` or one ``run()``),
its start and end and the small attributes given.  A counter records its
name, its amount, the innermost open span and the time.  ``anchor_ns``
holds ``time.time_ns() - time.perf_counter_ns()`` taken at ``enable()`` and
again at ``drain()``: adding it puts a span on the unix-nanosecond clock of
a torch.profiler trace, and the two readings' difference is the drift.

Tracing is off by default; then ``span()`` is one flag test that returns a
shared no-op context (no clock read, no record) and ``count()`` one flag
test.  A span never synchronizes or touches a device, on or off.  The
tracer serves one thread: spans nest as the ``with`` blocks do.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, NamedTuple

import torch


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int           # 0 at a unit's root
    unit: int             # id of the root span open around it
    t0: int               # time.perf_counter_ns()
    t1: int
    attrs: dict


class CountRecord(NamedTuple):
    name: str
    n: int
    span: int             # innermost open span, 0 outside any
    unit: int
    t: int


class _NoSpan:
    """The shared context of a disabled span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NO_SPAN = _NoSpan()


def clock_anchor() -> int:
    """time.time_ns() - time.perf_counter_ns(): perf-counter nanoseconds
    plus this are unix nanoseconds."""
    return time.time_ns() - time.perf_counter_ns()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "id", "parent", "unit", "t0")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        tr = self.tracer
        tr._next_id += 1
        self.id = tr._next_id
        stack = tr._stack
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.parent, self.unit = 0, self.id
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr._stack.pop()
        tr.spans.append(SpanRecord(self.name, self.id, self.parent, self.unit, self.t0, t1,
                                   self.attrs))
        return None


class Tracer:
    """Spans and counters in memory; see the module's docstring."""

    def __init__(self):
        self.on = False
        self.spans: list = []
        self.counts: list = []
        self._stack: list = []
        self._next_id = 0
        self._anchor = None

    def enable(self) -> None:
        self._anchor = clock_anchor()
        self.on = True

    def disable(self) -> None:
        self.on = False

    def drain(self) -> dict:
        """The records so far, handed over and cleared, with the clock
        anchor at enable() and now."""
        out = {"spans": self.spans, "counts": self.counts,
               "anchor_ns": (self._anchor, clock_anchor())}
        self.spans, self.counts = [], []
        return out

    def count(self, name: str, n: int = 1) -> None:
        top = self._stack[-1] if self._stack else None
        self.counts.append(CountRecord(name, int(n), top.id if top else 0,
                                       top.unit if top else 0, time.perf_counter_ns()))


#: the process's tracer, which the solvers' spans record into
TRACER = Tracer()


def span(name: str, **attrs):
    """``with span("lm.trial"):`` records a span while tracing is on."""
    if not TRACER.on:
        return NO_SPAN
    return _Span(TRACER, name, attrs)


def count(name: str, n: int = 1) -> None:
    if TRACER.on:
        TRACER.count(name, n)


def enabled() -> bool:
    """Whether tracing is on: a caller computes a counter's amount only then."""
    return TRACER.on


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def drain() -> dict:
    return TRACER.drain()


class StageTimer:
    """Accumulates wall time per named stage; `with timer.stage("chol"):`.
    Each stage is also a tracer span of its name."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self._sync_device = dev if dev is not None and dev.type == "cuda" else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self._sync_device is not None:
                    torch.cuda.synchronize(self._sync_device)
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def dump(self, total: float = None) -> str:
        """Formatted breakdown like the reference solver Dump() output."""
        lines = []
        acc = sum(self.totals.values())
        denom = total if total else acc
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"\t{name:>8}: {t:.6f} ({100 * t / max(denom, 1e-12):.1f}%)"
                         f" x{self.counts[name]}")
        return "\n".join(lines)
