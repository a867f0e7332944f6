"""factor_ms.ba: milliseconds per call of the sparse-reduced Schur's block
Cholesky (SchurSolver.reduced_chol.solve): the mean of the window's spans,
each synchronised with the device on entry and exit."""


def read(ctx):
    times = ctx.spans.get("factor")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
