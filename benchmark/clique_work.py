"""The least work of the clique path's forward elimination (kernel K3a),
by K1's rule: what the real observations need, whatever implements the
stage.

Per observation: its Bl x Bp block of H_pl read once with its camera id;
the operations are its W = U C^-1 product, 3 x 3 by 3 x 6.  The pair
products, the per-landmark C^-1, eta and the outputs (a run's counts give
no landmark or SC block count) count nothing, which only lowers the least
time, so the reading cannot pass 100% by counting too much.
"""

from __future__ import annotations

#: values of one observation's block (Bl x Bp = 3 x 6)
CLIQUE_BLOCK_VALUES = 3 * 6
#: bytes of a camera id (int32)
CAMERA_ID_BYTES = 4
#: operations per observation: W = U C^-1, 3 x 3 by 3 x 6, a multiply and
#: an add each
CLIQUE_FLOPS = 2 * 3 * 3 * 6


def clique_work(n_obs: int, itemsize: int):
    """(bytes, operations) the forward elimination needs for n_obs real
    observations: each block read once with its camera id, W formed once."""
    return n_obs * (CLIQUE_BLOCK_VALUES * itemsize + CAMERA_ID_BYTES), n_obs * CLIQUE_FLOPS
