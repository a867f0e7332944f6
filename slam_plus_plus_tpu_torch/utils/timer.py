"""Per-stage timing accumulation.

Port of slam_plus_plus_tpu/utils/timer.py (reference CTimer / CDeltaTimer /
CTimerSampler, include/slam/Timer.h:229-391, and the per-stage accumulators
every solver prints from Dump(), e.g. m_f_lambda_time,
include/slam/NonlinearSolver_Lambda.h:250).

Given a CUDA device, a stage synchronizes that device before it reads the
clock on exit, so the stage's time includes the kernels it queued; without
one it measures host wall time, as the JAX package's timer does.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch


class StageTimer:
    """Accumulates wall time per named stage; `with timer.stage("chol"):`."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self._sync_device = dev if dev is not None and dev.type == "cuda" else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
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
