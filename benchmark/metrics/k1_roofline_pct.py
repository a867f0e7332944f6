"""k1_roofline_pct: the P2C edge stage's least time over K1's device time
per launch, in percent.  Least time: the larger of the bytes the stage
needs for the real observations (inputs read once, outputs written once) at
the memory rate and its operations at the dtype's peak
(benchmark/roofline.py).  Device time: K1's activities in the profiled
unit.  Nothing when K1 did not run."""

from benchmark import roofline


def read(ctx):
    n, seconds = ctx.trace.kernels("p2c_kernel")
    if n == 0 or seconds <= 0:
        return None
    nbytes, flops = roofline.p2c_work(ctx.counts["observations"], ctx.itemsize)
    least, _ = roofline.least_seconds(nbytes, flops, ctx.itemsize)
    return 100.0 * least / (seconds / n)
