"""The card's peaks and the least time of each measured stage, from the
stage's shapes.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: HBM 3.35
TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}          # itemsize -> FLOP/s

#: the P2C edge stage, per observation: inputs read once (camera 11, point
#: 3, measurement 2, information 4 values) and outputs written once (chi2,
#: the Hessian diagonal's maximum, the camera and point gradients 6 + 3, the
#: camera, camera-point and point Hessian blocks 36 + 18 + 9)
P2C_IN_VALUES = 11 + 3 + 2 + 4
P2C_OUT_VALUES = 1 + 1 + 6 + 3 + 36 + 18 + 9
#: operations per observation (the rotation, projection, Jacobians and block
#: products; sin, cos, sqrt and division one each)
P2C_FLOPS = 420


def p2c_work(n_obs: int, itemsize: int):
    """(bytes, operations) the P2C edge stage needs for n_obs real
    observations: padded slots count nothing, and a stage that also reduces
    the terms needs no more."""
    return n_obs * (P2C_IN_VALUES + P2C_OUT_VALUES) * itemsize, n_obs * P2C_FLOPS


def least_seconds(nbytes: float, flops: float, itemsize: int):
    """(seconds, "bytes" or "operations"): the larger of the bytes at the
    memory rate and the operations at the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[itemsize]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
