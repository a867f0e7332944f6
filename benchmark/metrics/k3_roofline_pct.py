"""k3_roofline_pct: the clique path's forward elimination's least time over
K3a's device time per launch, in percent.  Least time: the larger of the
bytes the stage needs for the real observations (benchmark/clique_work.py:
each block read once with its camera id) at the memory rate and its
operations (W = U C^-1) at the dtype's peak (benchmark/roofline.py).
Device time: K3a's two kernels (its pass over the landmarks and its sum of
the partials) in the profiled unit, over the launches of the first.
Nothing when K3a did not run."""

from benchmark import roofline
from benchmark.clique_work import clique_work


def read(ctx):
    n, seconds = ctx.trace.kernels("clique_fwd_kernel")
    if n == 0 or seconds <= 0:
        return None
    seconds += ctx.trace.kernels("clique_sum_kernel")[1]
    nbytes, flops = clique_work(ctx.counts["observations"], ctx.itemsize)
    least, _ = roofline.least_seconds(nbytes, flops, ctx.itemsize)
    return 100.0 * least / (seconds / n)
