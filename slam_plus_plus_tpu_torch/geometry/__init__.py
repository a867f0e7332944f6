"""Geometry: minimal solvers, triangulation, distortion (host numpy), and
the batched closed-form polynomial roots and structure averaging (torch)."""
from slam_plus_plus_tpu_torch.geometry import distortion, minimal, triangulate

__all__ = ["minimal", "triangulate", "distortion"]
