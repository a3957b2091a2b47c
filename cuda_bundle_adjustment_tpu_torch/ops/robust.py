"""Robust M-estimator kernels as pure functions of the squared error.

``rho(x)`` rescales the per-edge chi2 value and ``rho'(x)`` rescales the
information weight in the quadratic form (counterpart of the JAX package's
``ops/robust.py``).  The solver applies ``rho`` to the per-edge output of
kernel B1 and ``rho'`` to the weight it hands kernel B3.
"""

from __future__ import annotations

import enum

import torch


class RobustKernelType(enum.IntEnum):
    NONE = 0
    TUKEY = 1
    CAUCHY = 2
    HUBER = 3


def robustify(kind: int, delta: float, x: torch.Tensor) -> torch.Tensor:
    """``rho(x)`` applied to squared errors ``x = omega * ||e||^2``."""
    if kind == RobustKernelType.NONE:
        return x
    d2 = delta * delta
    if kind == RobustKernelType.TUKEY:
        maxv = d2 / 3.0
        r = 1.0 - x / d2
        return torch.where(x <= d2, maxv * (1.0 - r * r * r), maxv)
    if kind == RobustKernelType.CAUCHY:
        return d2 * torch.log(x / d2 + 1.0)
    if kind == RobustKernelType.HUBER:
        # g2o-style Huber on the squared error: x if |e| <= delta else
        # 2*delta*sqrt(x) - delta^2
        sq = torch.sqrt(torch.clamp(x, min=0.0))
        return torch.where(x <= d2, x, 2.0 * delta * sq - d2)
    raise ValueError(f"unknown robust kernel kind {kind}")


def robust_derivative(kind: int, delta: float, x: torch.Tensor) -> torch.Tensor:
    """``rho'(x)`` used to scale omega in the quadratic form."""
    if kind == RobustKernelType.NONE:
        return torch.ones_like(x)
    d2 = delta * delta
    if kind == RobustKernelType.TUKEY:
        r = 1.0 - x / d2
        return torch.where(x <= d2, r * r, 0.0)
    if kind == RobustKernelType.CAUCHY:
        return 1.0 / (x / d2 + 1.0)
    if kind == RobustKernelType.HUBER:
        sq = torch.sqrt(torch.clamp(x, min=1e-300))
        return torch.where(x <= d2, torch.ones_like(x), delta / sq)
    raise ValueError(f"unknown robust kernel kind {kind}")
