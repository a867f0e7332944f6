"""Linear solvers (the uniform dense Schur branch)."""
