"""The least work of the Schur panel stage (kernel K2), by K1's rule: what
the real observations need, whatever implements the stage.

Per observation: its Bl x Bp block of H_pl read once with its camera id,
and its U and W = C^-1 U blocks written once; the operations are the 3 x 3
by 3 x 6 product of W.  The zeros of the dense panels that K2 writes count
nothing, and neither does the per-landmark C^-1 read (a run's counts
give no landmark count), which only lowers the least time.
"""

from __future__ import annotations

#: values of one observation's block (Bl x Bp = 3 x 6)
PANEL_BLOCK_VALUES = 3 * 6
#: bytes of a camera id (int32)
CAMERA_ID_BYTES = 4
#: operations per observation: W = C^-1 U, 3 x 3 by 3 x 6, a multiply and
#: an add each
PANEL_FLOPS = 2 * 3 * 3 * 6


def panel_work(n_obs: int, itemsize: int):
    """(bytes, operations) the panel stage needs for n_obs real
    observations: each block read once with its camera id, U and W written
    once."""
    nbytes = n_obs * (3 * PANEL_BLOCK_VALUES * itemsize + CAMERA_ID_BYTES)
    return nbytes, n_obs * PANEL_FLOPS
