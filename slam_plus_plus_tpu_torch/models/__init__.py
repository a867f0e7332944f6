"""Vertex/edge types.  Importing this package registers every type of the
JAX package: the BA families (mono ``edge_p2c``, intrinsics ``edge_p2ci``,
stereo ``edge_p2sc``, spheron ``edge_spheron_xyz``), the SE(2)/SE(3)
pose-graph and landmark families, the Sim(3) grid and ROCV."""

from slam_plus_plus_tpu_torch.models import (  # noqa: F401
    ba_types,
    rocv_types,
    se2_types,
    se3_types,
    sim3_types,
)
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
