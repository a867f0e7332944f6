"""Robust loss weights (IRLS) in torch."""
