"""k2_roofline_pct: the Schur panel stage's least time over K2's device
time per launch, in percent.  Least time: the larger of the bytes the stage
needs for the real observations (benchmark/panel_work.py: each block read
once with its camera id, its U and W written once; the dense panels' zeros
count nothing) at the memory rate and its operations at the dtype's peak
(benchmark/roofline.py).  Device time: K2's activities in the profiled
unit.  Nothing when K2 did not run."""

from benchmark import roofline
from benchmark.panel_work import panel_work


def read(ctx):
    n, seconds = ctx.trace.kernels("panel_kernel")
    if n == 0 or seconds <= 0:
        return None
    nbytes, flops = panel_work(ctx.counts["observations"], ctx.itemsize)
    least, _ = roofline.least_seconds(nbytes, flops, ctx.itemsize)
    return 100.0 * least / (seconds / n)
