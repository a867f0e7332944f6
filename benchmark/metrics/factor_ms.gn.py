"""factor_ms.gn: milliseconds per linear solve of a GN iteration on the
pose graph's block Cholesky (GaussNewtonSolver._solve: the factor and the
solve of ``sparse_solve``): the mean of the spans after the window, each
synchronised with the device on entry and exit."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.spans.get("factor"))
