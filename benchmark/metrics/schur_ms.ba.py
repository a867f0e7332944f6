"""schur_ms.ba: milliseconds per call of SchurSolver.solve (C^-1, the
clique fill, the reduced factor and the back-substitution): the mean of
the window's spans, each synchronised with the device on entry and exit."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.spans.get("schur"))
