"""Linear solvers: the Schur complement, the MIS-Schur block Cholesky, the
dense factor, the block SpMV and the host scipy oracle."""
