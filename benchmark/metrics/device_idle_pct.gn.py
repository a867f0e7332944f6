"""device_idle_pct.gn: the device's idle share in a GN batch solve, in
percent (``benchmark.trace.idle_pct``; the profiled part is the whole
solve)."""

from benchmark.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace, ctx.part_s)
