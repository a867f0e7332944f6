"""assemble_ms.ba: milliseconds per call of Assembler.assemble (K1 and the
reductions): the mean of the window's spans, each synchronised with the
device on entry and exit."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.spans.get("assemble"))
