"""Trajectory evaluation (ATE / RPE) against ground truth."""
