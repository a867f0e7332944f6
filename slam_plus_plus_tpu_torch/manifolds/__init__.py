"""Batched manifold math in torch (SO3, SE3, the mono camera)."""
