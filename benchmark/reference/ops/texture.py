"""Texture coordinates and the bilinear atlas fetch
(``path_tracing_tpu.ops.texture``).

The atlas is ``(NT, TH+1, TW+1, 3)`` float32: texture ``t`` fills the
top-left ``size[t] = (h, w)`` texels of its slice plus a one-texel wrapped
border (row h = row 0, col w = col 0), built by ``scene/parser.py``.  The
CUDA textured bounce (``shade_step_tex``) fetches the same 2x2 footprint
per lane inside the kernel (``sample_bilinear_dev`` in
``csrc/pt_device.cuh``); these are the plain versions, written in the
kernel's order of operations.
"""
from __future__ import annotations

import torch


def interpolate_uv(uv6: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """Barycentric UV interpolation: ``uv6`` (B, 6) vertex UVs
    ``[u0, v0, u1, v1, u2, v2]``, ``u, v`` (B,) Moller-Trumbore
    barycentrics (weights of v1 and v2).  Returns (B, 2)."""
    w0 = 1.0 - u - v
    iu = w0 * uv6[:, 0] + u * uv6[:, 2] + v * uv6[:, 4]
    iv = w0 * uv6[:, 1] + u * uv6[:, 3] + v * uv6[:, 5]
    return torch.stack([iu, iv], dim=-1)


def sample_bilinear(atlas: torch.Tensor, size: torch.Tensor,
                    tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with wrap (repeat) addressing, v pointing up and
    texel centers at half-integers.  ``tex_id`` (B,) int (callers mask
    ids < 0 themselves), ``uv`` (B, 2).  Returns (B, 3) linear RGB.

    The footprint starts at the floor-mod wrapped texel (``remainder``,
    not the truncating ``fmod``: negative uv wrap like positive ones) and
    is clamped into the slice as the JAX package's CLIP-mode gather clamps
    its start; the +1 texel lands in the wrapped border."""
    n_tex, th1, tw1 = atlas.shape[0], atlas.shape[1], atlas.shape[2]
    t = torch.clamp(tex_id.long(), 0, n_tex - 1)
    h = size[t, 0].to(torch.float32)
    w = size[t, 1].to(torch.float32)
    fu = uv[:, 0] - torch.floor(uv[:, 0])
    fv = uv[:, 1] - torch.floor(uv[:, 1])
    x = fu * w - 0.5
    y = (1.0 - fv) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ax = (x - x0)[:, None]
    ay = (y - y0)[:, None]

    def wrap(i, n):
        return torch.remainder(i.to(torch.int32),
                               torch.clamp(n.to(torch.int32), min=1))

    xi = torch.clamp(wrap(x0, w), 0, tw1 - 2).long()
    yi = torch.clamp(wrap(y0, h), 0, th1 - 2).long()
    bx, by = 1.0 - ax, 1.0 - ay
    top = atlas[t, yi, xi] * bx + atlas[t, yi, xi + 1] * ax
    bot = atlas[t, yi + 1, xi] * bx + atlas[t, yi + 1, xi + 1] * ax
    return top * by + bot * ay
