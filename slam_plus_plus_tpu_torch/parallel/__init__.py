"""Multi-process solving over torch.distributed (port of
slam_plus_plus_tpu/parallel/): edge-sharded assembly and Schur panel
products, the distributed MIS block Cholesky, landmark-sharded BA and the
process-group wiring.  The classes take ``group=`` where the JAX package
takes a mesh (``make_edge_mesh`` / ``make_lm_mesh`` have no counterpart)."""

from slam_plus_plus_tpu_torch.parallel.dist import DistributedAssembler, DistributedSchurSolver
from slam_plus_plus_tpu_torch.parallel.sharded_ba import ShardedBAOptimizer
from slam_plus_plus_tpu_torch.parallel.dist_cholesky import DistributedBlockCholeskySolver
from slam_plus_plus_tpu_torch.parallel import multihost

__all__ = ["DistributedAssembler", "DistributedSchurSolver", "ShardedBAOptimizer",
           "DistributedBlockCholeskySolver", "multihost"]
