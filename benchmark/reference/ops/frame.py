"""Local shading frames and local-space trigonometry (``path_tracing_tpu.ops.frame``).
Local space puts the shading normal at +z."""
from __future__ import annotations

import torch

from .math3 import cross, dot, normalize


def build_local_frame(n: torch.Tensor):
    """Tangent and bitangent for normal ``n``: cross with +z unless
    |n.z| >= 0.999, then with +y."""
    z_axis = torch.zeros_like(n)
    z_axis[..., 2] = 1.0
    y_axis = torch.zeros_like(n)
    y_axis[..., 1] = 1.0
    use_z = (torch.abs(n[..., 2]) < 0.999)[..., None]
    t = normalize(torch.where(use_z, cross(z_axis, n), cross(y_axis, n)))
    b = cross(n, t)
    return t, b


def world_to_local(v, t, b, n) -> torch.Tensor:
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def local_to_world(v, t, b, n) -> torch.Tensor:
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / (cos_theta(w) + 1e-7)


def tan2_theta(w):
    return sin2_theta(w) / (cos2_theta(w) + 1e-7)
