"""The device's idle share, in percent: 1 - the busy time of the profiled
part of a unit, profiled with the device's activities alone (the union of
their intervals), over the wall time of that part untraced, the median of
the same run's window.  The profiled part's own wall would count what the
profiler adds to the host's time as idle."""


def read(ctx):
    if not ctx.trace.n_device or ctx.part_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.part_s)
