"""Trowbridge-Reitz (GGX) microfacet model with VNDF sampling
(``path_tracing_tpu.ops.microfacet``).  Directions are in the local frame."""
from __future__ import annotations

import torch

from .frame import cos2_theta, tan2_theta, tan_theta
from .math3 import PI, cross, normalize


def roughness_to_alpha(roughness: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(roughness, min=1e-3)
    return x * x


def tr_d(wh: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """GGX D with the reference's denominator ``cos^4 (alpha^2 + tan^4)``
    instead of textbook ``cos^4 (alpha^2 + tan^2)^2``.  This D is not
    normalized (its projected integral is pi*alpha/2); converged images
    depend on the shape, so it is kept as it is."""
    t2 = tan2_theta(wh)
    cos4 = cos2_theta(wh) * cos2_theta(wh)
    e = cos4 * (alpha * alpha + t2 * t2)
    d = (alpha * alpha) / (PI * e)
    bad = torch.isinf(t2) | (e < 1e-12)
    return torch.where(bad, torch.zeros_like(d), d)


def tr_lambda(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    abs_tan = torch.abs(tan_theta(w))
    a2t2 = (alpha * abs_tan) * (alpha * abs_tan)
    lam = (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0
    return torch.where(torch.isinf(abs_tan), torch.zeros_like(lam), lam)


def tr_g(wo, wi, alpha) -> torch.Tensor:
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_g1(w, alpha) -> torch.Tensor:
    return 1.0 / (1.0 + tr_lambda(w, alpha))


def sample_tr_visible_normal(wo, alpha, u1, u2) -> torch.Tensor:
    """Heitz VNDF sample of a visible microfacet normal; ``wo`` must be in
    the upper hemisphere."""
    a = alpha[..., None]
    v = normalize(torch.cat([a * wo[..., 0:1], a * wo[..., 1:2],
                             wo[..., 2:3]], dim=-1))
    z_axis = torch.zeros_like(v)
    z_axis[..., 2] = 1.0
    x_axis = torch.zeros_like(v)
    x_axis[..., 0] = 1.0
    use_cross = (v[..., 2] < 0.9999)[..., None]
    cz = cross(z_axis, v)
    t1 = torch.where(use_cross, normalize(cz), x_axis)
    t2 = cross(v, t1)

    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2

    nh = (t1 * p1[..., None] + t2 * p2[..., None]
          + v * torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2,
                                       min=0.0))[..., None])
    wh = torch.cat([a * nh[..., 0:1], a * nh[..., 1:2],
                    torch.clamp(nh[..., 2:3], min=0.0)], dim=-1)
    return normalize(wh)
