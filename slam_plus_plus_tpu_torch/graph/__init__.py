"""Typed columnar factor-graph container."""
