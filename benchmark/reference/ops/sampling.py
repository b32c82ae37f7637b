"""Direction and light-emission sampling (``path_tracing_tpu.ops.sampling``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math3 import PI, cross, dot, normalize


def uniform_sphere_dir(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _light_frame(w: torch.Tensor):
    """The reference's frame around a light direction: u0 = +y if
    |w.x| > 0.9 else +x, v = normalize(w x u0), u = normalize(v x w)."""
    y_axis = torch.zeros_like(w)
    y_axis[..., 1] = 1.0
    x_axis = torch.zeros_like(w)
    x_axis[..., 0] = 1.0
    u0 = torch.where((torch.abs(w[..., 0]) > 0.9)[..., None], y_axis, x_axis)
    v = normalize(cross(w, u0))
    u = normalize(cross(v, w))
    return u, v


class EmissionSample(NamedTuple):
    origin: torch.Tensor     # (..., 3)
    direction: torch.Tensor  # (..., 3)


def sample_light_emission(light_pos, light_dir, light_cutoff, is_parallel,
                          ball_r, scene_min, scene_max, u1: torch.Tensor,
                          u2: torch.Tensor) -> EmissionSample:
    """An emitted ray per light row.  Spot-sphere lights: a cone-uniform
    direction around ``light_dir`` within ``cutoff``, the origin on the
    ball surface.  Parallel lights: the fixed direction, the origin
    jittered on a plane of side ``2 * scene_radius`` placed ``2 *
    scene_radius`` behind the scene center ``(min + max) / 2``."""
    w = normalize(light_dir)
    u, v = _light_frame(w)

    theta = torch.acos(1.0 - u1 * (1.0 - torch.cos(light_cutoff)))
    phi = 2.0 * PI * u2
    st = torch.sin(theta)
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                         torch.cos(theta)], dim=-1)
    spot_dir = normalize(u * local[..., 0:1] + v * local[..., 1:2]
                         + w * local[..., 2:3])
    spot_origin = light_pos + spot_dir * ball_r[..., None]

    center = (scene_min + scene_max) * 0.5
    ext = scene_max - scene_min
    radius = 0.5 * torch.sqrt(dot(ext, ext))
    plane = radius * 2.0
    off_u = (u1 - 0.5) * plane
    off_v = (u2 - 0.5) * plane
    par_origin = (center - w * (radius * 2.0)
                  + u * off_u[..., None] + v * off_v[..., None])

    par = (is_parallel != 0)[..., None]
    return EmissionSample(origin=torch.where(par, par_origin, spot_origin),
                          direction=torch.where(par, w, spot_dir))
