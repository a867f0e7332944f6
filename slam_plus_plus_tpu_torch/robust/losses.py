"""Robust loss weight functions (port of slam_plus_plus_tpu/robust/losses.py,
reference include/geometry/RobustLoss.h:55-393).

Each function returns the IRLS weight w(x) = psi(x)/x for a scaled error
magnitude x >= 0 (a tensor, any shape), with the reference's default tuning
constants (95% asymptotic efficiency for Gaussian noise).  The assembler
scales an edge's information by w, re-evaluated at every linearization.

The reference's SE(3) pose edge uses Huber with error scale 0.3
(reference include/slam/SE3_Types.h:128-129).
"""

from __future__ import annotations

import torch


def huber_weight(x, a=1.345):
    x = torch.abs(x)
    return torch.where(x <= a, torch.ones_like(x), a / torch.clamp_min(x, 1e-30))


def cauchy_weight(x, a=2.385):
    return a * a / (a * a + x * x)


def tukey_weight(x, a=4.685):
    x = torch.abs(x)
    t = 1.0 - (x / a) ** 2
    return torch.where(x <= a, t * t, torch.zeros_like(x))


def hampel_weight(x, a=1.5, b=3.5, c=8.0):
    x = torch.abs(x)
    xs = torch.clamp_min(x, 1e-30)
    w_mid = a / xs
    w_tail = a * (c - x) / (c - b) / xs
    return torch.where(x <= a, torch.ones_like(x),
                       torch.where(x <= b, w_mid,
                                   torch.where(x <= c, w_tail, torch.zeros_like(x))))


def logistic_weight(x, a=1.205):
    xs = torch.clamp_min(torch.abs(x), 1e-12) / a
    return torch.tanh(xs) / xs


def fair_weight(x, a=1.4):
    return 1.0 / (1.0 + torch.abs(x) / a)


def welsch_weight(x, a=2.985):
    return torch.exp(-((x / a) ** 2))


LOSSES = {
    "huber": huber_weight,
    "cauchy": cauchy_weight,
    "tukey": tukey_weight,
    "hampel": hampel_weight,
    "logistic": logistic_weight,
    "fair": fair_weight,
    "welsch": welsch_weight,
    # unit weight: plain least squares for a robust-capable edge type
    "none": torch.ones_like,
}
