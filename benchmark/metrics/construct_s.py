"""construct_s: the solver's own construction seconds (its host plan:
the assembler's structure, the Schur or replay plan), ``timing["construct"]``."""


def read(ctx):
    return ctx.construct_s
