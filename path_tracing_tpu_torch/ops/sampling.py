"""Direction sampling (``path_tracing_tpu.ops.sampling``)."""
from __future__ import annotations

import torch

from .math3 import PI


def uniform_sphere_dir(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
