"""assemble_ms.ba: milliseconds per call of Assembler.assemble (K1 and the
reductions): the mean of the window's spans, each synchronised with the
device on entry and exit."""


def read(ctx):
    times = ctx.spans.get("assemble")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
