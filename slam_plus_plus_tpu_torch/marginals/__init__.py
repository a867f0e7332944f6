from slam_plus_plus_tpu_torch.marginals.covariance import (IncrementalMarginals, Marginals,
                                                           MarginalsResult)

__all__ = ["IncrementalMarginals", "Marginals", "MarginalsResult"]
