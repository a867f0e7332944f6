"""assemble_ms.gn: milliseconds per call of Assembler.assemble in a GN batch
solve (the pose graph's normal equations and chi2): the mean of the spans
after the window, each synchronised with the device on entry and exit."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.spans.get("assemble"))
