"""factor_ms.ba: milliseconds per call of the sparse-reduced Schur's block
Cholesky (SchurSolver.reduced_chol.solve): the mean of the window's spans,
each synchronised with the device on entry and exit."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.spans.get("factor"))
