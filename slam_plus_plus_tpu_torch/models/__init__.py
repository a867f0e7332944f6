"""Vertex/edge types.  Importing this package registers the ported types:
the BA families (mono ``edge_p2c``, intrinsics ``edge_p2ci``, stereo
``edge_p2sc``, spheron ``edge_spheron_xyz``) and the SE(2)/SE(3)
pose-graph and landmark families."""

from slam_plus_plus_tpu_torch.models import ba_types, se2_types, se3_types  # noqa: F401
from slam_plus_plus_tpu_torch.models.types import (
    EDGE_TYPES,
    VERTEX_TYPES,
    EdgeType,
    VertexType,
    edge_type,
    vertex_type,
)

__all__ = [
    "EdgeType",
    "VertexType",
    "EDGE_TYPES",
    "VERTEX_TYPES",
    "edge_type",
    "vertex_type",
]
