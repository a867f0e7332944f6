"""Vertex/edge type registry (port of slam_plus_plus_tpu/models/types.py).

A type is data: dimensions plus batched torch functions.  ``boxplus`` and
``residual`` take a leading batch dimension (``[..., state_dim]``) instead of
being ``vmap``-ed over single elements.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

VERTEX_TYPES: Dict[str, "VertexType"] = {}
EDGE_TYPES: Dict[str, "EdgeType"] = {}


@dataclasses.dataclass(frozen=True)
class VertexType:
    """state_dim — stored state size; tangent_dim — Hessian block size;
    boxplus — batched retraction [..., state] x [..., tangent] -> [..., state];
    schur_class — "pose" forms the reduced system, "landmark" is eliminated."""

    name: str
    state_dim: int
    tangent_dim: int
    boxplus: Callable
    schur_class: str = "pose"


@dataclasses.dataclass(frozen=True)
class EdgeType:
    """residual — batched fn (vertex_states tuple, z) -> [..., residual_dim],
    r = z - h(x) with chi2 = r^T Sigma^-1 r (reference convention);
    initializer — host numpy fn creating missing vertices on insert;
    robust — IRLS weighting of the information by
    ``LOSSES[robust_loss](|r| / robust_scale)`` (reference robust mixins,
    include/slam/RobustUtils.h:368-502; CEdgePose3D, SE3_Types.h:128-129);
    expectation / error — the split form h = expectation(states),
    r = error(z, h): the Jacobians are then those of h, negated, as the
    reference differentiates h through the vertex ⊞ (SE3_Types.h:265-290);
    device_initializer — batched torch fn (vertex_states tuple, z, slot) ->
    the state of the vertex in ``slot``, placed from the edge at the current
    states when an incremental replay activates it (the JAX package's
    ``jax_initializer``; reference ParseLoop.h:138,399)."""

    name: str
    vertex_types: Tuple[str, ...]
    residual_dim: int
    measurement_dim: int
    residual: Callable
    initializer: Optional[Callable] = None
    robust: bool = False
    expectation: Optional[Callable] = None
    error: Optional[Callable] = None
    robust_loss: str = "huber"
    robust_scale: float = 0.3
    device_initializer: Optional[Callable] = None

    @property
    def arity(self) -> int:
        return len(self.vertex_types)


def vertex_type(name: str, state_dim: int, tangent_dim: int, boxplus: Callable,
                schur_class: str = "pose") -> VertexType:
    vt = VertexType(name, state_dim, tangent_dim, boxplus, schur_class)
    VERTEX_TYPES[name] = vt
    return vt


def edge_type(name: str, vertex_types: Sequence[str], residual_dim: int,
              measurement_dim: int, residual: Callable,
              initializer: Optional[Callable] = None,
              robust: bool = False,
              expectation: Optional[Callable] = None,
              error: Optional[Callable] = None,
              robust_loss: str = "huber",
              robust_scale: float = 0.3,
              device_initializer: Optional[Callable] = None) -> EdgeType:
    et = EdgeType(name, tuple(vertex_types), residual_dim, measurement_dim,
                  residual, initializer, robust, expectation, error,
                  robust_loss, robust_scale, device_initializer)
    EDGE_TYPES[name] = et
    return et
