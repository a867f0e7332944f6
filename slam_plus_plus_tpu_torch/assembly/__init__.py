"""Batched lambda/eta assembly."""
