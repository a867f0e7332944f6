"""device_idle_pct.inc: the device's idle share in a replay's profiled part
(the traffic's ``profile_part`` of the stream), in percent
(``benchmark.trace.idle_pct``)."""

from benchmark.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace, ctx.part_s)
