"""Nonlinear solvers (Levenberg-Marquardt over the dense Schur solve)."""
