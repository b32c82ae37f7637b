"""Batched 3-vector math on ``(..., 3)`` tensors (``path_tracing_tpu.ops.math3``).

Every function is written component by component in the order the CUDA
kernels use (``csrc/pt_device.cuh``): torch runs each elementwise op as its
own rounded step, so on the card the plain versions and the kernels
round alike.  ``normalize`` multiplies by the reciprocal of the length
floored at 1e-20, as the kernels do.
"""
from __future__ import annotations

import torch

EPSILON = 1e-4
PI = 3.14159265358979323846


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector: ``a * (1 / max(|a|, 1e-20))``."""
    return a * (1.0 / torch.clamp(length(a), min=1e-20))[..., None]


def is_valid_color(c: torch.Tensor) -> torch.Tensor:
    """NaN/Inf/negative rejection mask (True = valid)."""
    bad = torch.isnan(c) | torch.isinf(c) | (c < 0.0)
    return ~torch.any(bad, dim=-1)


def clamp_radiance(c: torch.Tensor, max_val: float) -> torch.Tensor:
    """Firefly clamp: scale so the largest channel is at most ``max_val``."""
    m = torch.maximum(c[..., 0], torch.maximum(c[..., 1], c[..., 2]))
    scale = torch.where(m > max_val, max_val / m, torch.ones_like(m))
    return c * scale[..., None]
