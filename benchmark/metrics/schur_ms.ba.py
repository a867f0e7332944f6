"""schur_ms.ba: milliseconds per call of SchurSolver.solve (C^-1, the
clique fill, the reduced factor and the back-substitution): the mean of
the window's spans, each synchronised with the device on entry and exit."""


def read(ctx):
    times = ctx.spans.get("schur")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
