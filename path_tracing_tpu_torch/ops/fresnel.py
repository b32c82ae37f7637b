"""Fresnel terms: exact dielectric and Schlick (``path_tracing_tpu.ops.fresnel``)."""
from __future__ import annotations

import torch

from ..profiling import span


def _like(eta, x: torch.Tensor) -> torch.Tensor:
    """``eta`` as ``x``'s dtype on its device, broadcast to its shape; a
    number or a tensor on another device is a blocking copy there
    (``sync.fresnel_eta``)."""
    if isinstance(eta, torch.Tensor) and eta.device == x.device:
        return eta.to(x.dtype).expand_as(x)
    with span("sync.fresnel_eta"):
        return torch.as_tensor(eta, dtype=x.dtype,
                               device=x.device).expand_as(x)


def fr_dielectric(cos_theta_i: torch.Tensor, eta_i, eta_t) -> torch.Tensor:
    """Unpolarized dielectric reflectance; swaps the media when exiting
    (cos < 0) and returns 1 on total internal reflection."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    eta_i = _like(eta_i, cos_i)
    eta_t = _like(eta_t, cos_i)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cos_i = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = ((et * cos_i) - (ei * cos_t)) / ((et * cos_i) + (ei * cos_t))
    r_perp = ((ei * cos_i) - (et * cos_t)) / ((ei * cos_i) + (et * cos_t))
    fr = (r_parl * r_parl + r_perp * r_perp) / 2.0
    return torch.where(tir, torch.ones_like(fr), fr)


def fr_schlick(cos_theta_i: torch.Tensor, r0: torch.Tensor) -> torch.Tensor:
    """Schlick approximation with RGB F0 (``(..., 3)``)."""
    c = torch.clamp(1.0 - cos_theta_i, min=0.0)
    c5 = c * c * c * c * c
    return r0 + (1.0 - r0) * c5[..., None]
