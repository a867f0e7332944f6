"""Host utilities of the port: the stage timer, matrix I/O, FLOP counts and
the memory line."""
from slam_plus_plus_tpu_torch.utils import flops, matrix_io, memusage, timer

__all__ = ["timer", "matrix_io", "flops", "memusage"]
